"""The EMCAD decoder library, 1-D, as ``nn.Module``s (counterpart of
``tdanet_tpu/models/emcad.py``): MSDC / MSCB multi-scale depthwise
blocks with channel shuffle, EUCB up-convolutions, LGAG attention gates,
CAB and SAB, and the seven decoders the EMCAD-era TDANet variants use.

Module and parameter names follow the JAX package's parameter tree (the
reference's ``nn.Sequential`` indices included: ``dwconvs.{i}.{0,1,2}``,
``up_dwc.{1,2,3}``, ``W_g.{0,1}``). Every norm is GroupNorm(1, C) at
torch's default eps 1e-5, and a PReLU starts at 0.2. The conv + norm
pairs go through the components' rule (:class:`SeqConvNorm`): MSDC's K
1/3/5 and EUCB's K3 depthwise convs run kernel #1 with eps 1e-5 and no
bias; the grouped pointwise convs and the LGAG gates (groups C/2 over C
inputs) are ``F.conv1d`` with ``groups`` and the plain norm. The
shift-FMA forms of the JAX package's grouped convs are TPU lowerings of
the same function and are not ported.
"""

from __future__ import annotations

from math import gcd

import torch
from torch import nn

from tdanet_tpu_torch.models.components import (
    GroupNorm1, conv_then_norm, routes_to_kernel)
from tdanet_tpu_torch.ops import basic as ops

EPS = 1e-5


class PReLU(nn.PReLU):
    """nn.PReLU(1) that ``reset_parameters`` starts at 0.2, as EMCAD's
    act_layer('prelu') does."""

    init_value = 0.2

    def __init__(self):
        super().__init__(1, self.init_value)


def make_act(name):
    """The parameter module of an activation: a PReLU for 'prelu', None
    for the others."""
    return PReLU() if name.lower() == "prelu" else None


def act(name, x, module=None):
    """The activation ``name`` (a PReLU's slope from ``module``)."""
    return ops.activation(name, x, None if module is None else module.weight)


def channel_shuffle(x, groups, times=1):
    """Transpose (groups, C / groups) of the channels, ``times`` times."""
    B, C, L = x.shape
    for _ in range(times):
        x = x.reshape(B, groups, C // groups, L).transpose(1, 2) \
            .reshape(B, C, L)
    return x


class SeqConvNorm(nn.Module):
    """conv ('same' padding) -> GroupNorm(1, C, eps 1e-5) [-> activation]
    under the reference's ``nn.Sequential`` indices: the conv at
    ``first``, the norm at ``first + 1``, a PReLU's slope at ``first + 2``.
    The conv and the norm run through :func:`conv_then_norm`, #1 where
    :func:`routes_to_kernel` says so."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, bias=True,
                 activation=None, first=0):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.names = (str(first), str(first + 1), str(first + 2))
        conv = nn.Conv1d(n_in, n_out, kernel, stride=stride,
                         padding=self.padding, groups=groups, bias=bias)
        self.add_module(self.names[0], conv)
        self.add_module(self.names[1], GroupNorm1(n_out, EPS))
        self.activation = activation
        if activation is not None and make_act(activation) is not None:
            self.add_module(self.names[2], make_act(activation))
        self.on_kernel = routes_to_kernel(conv, stride, self.padding)

    def forward(self, x):
        conv, norm = (self._modules[n] for n in self.names[:2])
        x = conv_then_norm(x, conv, norm, self.stride, self.padding,
                           self.on_kernel)
        if self.activation is None:
            return x
        return act(self.activation, x, self._modules.get(self.names[2]))


class MSDC(nn.Module):
    """Depthwise convs at several kernel sizes, each + GroupNorm + act;
    ``dw_parallel=False`` adds each output into the next one's input."""

    def __init__(self, in_channels, kernel_sizes, stride, activation="relu6",
                 dw_parallel=True):
        super().__init__()
        self.dw_parallel = dw_parallel
        self.dwconvs = nn.ModuleList([
            SeqConvNorm(in_channels, in_channels, k, stride,
                        groups=in_channels, bias=False,
                        activation=activation)
            for k in kernel_sizes])

    def forward(self, x):
        outputs = []
        for dw in self.dwconvs:
            y = dw(x)
            outputs.append(y)
            if not self.dw_parallel:
                x = x + y
        return outputs


class MSCB(nn.Module):
    """Inverted-residual multi-scale conv block with channel shuffle;
    ``lite_v2``: grouped pointwise convs and extra shuffles."""

    def __init__(self, in_channels, out_channels, stride,
                 kernel_sizes=(1, 3, 5), expansion_factor=2,
                 dw_parallel=True, add=True, activation="relu6",
                 lite_v2=False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.add, self.lite_v2 = add, lite_v2
        ex = int(in_channels * expansion_factor)
        self.use_skip = stride == 1
        self.combined = ex if add else ex * len(kernel_sizes)
        self.pconv1 = SeqConvNorm(
            in_channels, ex, 1, groups=in_channels // 4 if lite_v2 else 1,
            bias=False, activation=activation)
        self.msdc = MSDC(ex, list(kernel_sizes), stride, activation,
                         dw_parallel)
        self.pconv2 = SeqConvNorm(
            self.combined, out_channels, 1,
            groups=self.combined // 4 if lite_v2 else 1, bias=False)
        if self.use_skip and in_channels != out_channels:
            self.conv1x1 = nn.Conv1d(in_channels, out_channels, 1,
                                     bias=False)

    def forward(self, x):
        y = self.pconv1(x)
        if self.lite_v2:
            y = channel_shuffle(y, self.in_channels // 4, 1)
        outs = self.msdc(y)
        if self.add:
            dout = outs[0]
            for o in outs[1:]:
                dout = dout + o
        else:
            dout = torch.cat(outs, dim=1)
        dout = channel_shuffle(dout, gcd(self.combined, self.out_channels),
                               2 if self.lite_v2 else 1)
        out = self.pconv2(dout)
        if self.lite_v2:
            out = channel_shuffle(out, self.combined // 4, 3)
        if not self.use_skip:
            return out
        if self.in_channels != self.out_channels:
            x = ops.conv1d_module(x, self.conv1x1)
        return x + out


class MSCBLayer(nn.ModuleList):
    """n sequential MSCBs, named '0', '1', ... as the reference's
    nn.Sequential."""

    def __init__(self, in_channels, out_channels, n=1, stride=1, **kw):
        super().__init__(
            [MSCB(in_channels, out_channels, stride, **kw)]
            + [MSCB(out_channels, out_channels, 1, **kw)
               for _ in range(1, n)])

    def forward(self, x):
        for block in self:
            x = block(x)
        return x


class EUCB(nn.Module):
    """Up-convolution: nearest upsample to the skip's length -> depthwise
    K3 conv + GroupNorm + act (#1's site) -> channel shuffle (``times``
    times, or none) -> pointwise conv (none when ``light``)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 activation="relu", light=False, shuffle=True,
                 shuffle_times=1):
        super().__init__()
        self.in_channels = in_channels
        self.light, self.shuffle = light, shuffle
        self.shuffle_times = shuffle_times
        self.up_dwc = SeqConvNorm(in_channels, in_channels, kernel_size,
                                  stride, groups=in_channels, bias=False,
                                  activation=activation, first=1)
        self.pwc = None if light else nn.ModuleList(
            [nn.Conv1d(in_channels, out_channels, 1)])

    def forward(self, x, target_len):
        x = self.up_dwc(ops.interpolate_nearest(x, target_len))
        if self.shuffle:
            x = channel_shuffle(x, self.in_channels, self.shuffle_times)
        if self.light:
            return x
        return ops.conv1d_module(x, self.pwc[0])


class LGAG(nn.Module):
    """Large-kernel grouped attention gate:
    x * sigmoid(GN(psi(act(GN(W_g g) + GN(W_x x)))))."""

    BRANCHES = ("W_g", "W_x")

    def __init__(self, F_g, F_l, F_int, kernel_size=3, groups=1,
                 activation="relu"):
        super().__init__()
        if kernel_size == 1:
            groups = 1
        self.activation_name = activation
        ins = {"W_g": F_g, "W_x": F_l, "W_x_bottom": F_l}
        for name in self.BRANCHES:
            self.add_module(name, SeqConvNorm(ins[name], F_int, kernel_size,
                                              groups=groups))
        self.psi = SeqConvNorm(F_int, 1, 1)
        self.activation = make_act(activation)

    def forward(self, g, x, *more):
        s = self.W_g(g) + self.W_x(x)
        for name, m in zip(self.BRANCHES[2:], more):
            s = s + self._modules[name](m)
        psi = torch.sigmoid(self.psi(act(self.activation_name, s,
                                         self.activation)))
        return x * psi


class LGAG3(LGAG):
    """The three-input gate: an extra bottom branch ``W_x_bottom``;
    forward(g, x, x_bottom)."""

    BRANCHES = ("W_g", "W_x", "W_x_bottom")


class CAB(nn.Module):
    """Channel attention: sigmoid(2 fc2(act(fc1(mean(x))))) (the
    reference's "max pool" is an average pool too, so both branches are
    the same)."""

    def __init__(self, in_channels, out_channels=None, ratio=16,
                 activation="relu"):
        super().__init__()
        if in_channels < ratio:
            ratio = in_channels
        reduced = in_channels // ratio
        self.activation_name = activation
        self.fc1 = nn.Conv1d(in_channels, reduced, 1, bias=False)
        self.fc2 = nn.Conv1d(reduced, out_channels or in_channels, 1,
                             bias=False)
        self.activation = make_act(activation)

    def forward(self, x):
        pooled = x.mean(dim=-1, keepdim=True)
        z = act(self.activation_name, ops.conv1d_module(pooled, self.fc1),
                self.activation)
        z = ops.conv1d_module(z, self.fc2)
        return torch.sigmoid(z + z)


class SAB(nn.Module):
    """Spatial attention: sigmoid(conv([mean_C(x), max_C(x)]))."""

    def __init__(self, kernel_size=7):
        super().__init__()
        assert kernel_size in (3, 7, 11)
        self.conv = nn.Conv1d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x):
        y = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(ops.conv1d(y, self.conv.weight,
                                        padding=self.conv.padding[0]))


class EMCADBase(nn.Module):
    """The configurable EMCAD decoder over a 5-stage pyramid (the class
    attributes choose the variant, as in the JAX package):
    ``MSCB_STAGES`` keep their MSCB; ``LIGHT_STAGES`` use the light EUCB;
    ``EUCB_SHUFFLE`` (the light EUCB's shuffle), ``EUCB_SHUFFLE_TIMES``;
    ``USE_LGAG``, ``USE_CBAM``, ``LGAG4`` (a gate at the coarsest stage and
    no CBAM), ``LITE_V2``, ``RETURN_ALL``.

    forward(x, skips): x the coarsest global feature, skips the per-scale
    features fine -> coarse; the stage outputs coarse -> fine (or only the
    finest)."""

    MSCB_STAGES = (4, 3, 2, 1, 0)
    LIGHT_STAGES = ()
    EUCB_SHUFFLE = True
    EUCB_SHUFFLE_TIMES = 1
    USE_LGAG = True
    USE_CBAM = True
    LGAG4 = False
    LITE_V2 = False
    RETURN_ALL = True

    def __init__(self, channels=(512, 320, 128, 64, 64),
                 kernel_sizes=(1, 3, 5), expansion_factor=6,
                 dw_parallel=True, add=True, lgag_ks=3, activation="relu",
                 feat_len=None):
        super().__init__()
        if len(channels) != 5:
            raise ValueError(
                "EMCAD decoder requires a 5-stage pyramid "
                f"(upsampling_depth=5); got {len(channels)} channels")
        ch = list(channels)
        mk = dict(kernel_sizes=kernel_sizes,
                  expansion_factor=expansion_factor, dw_parallel=dw_parallel,
                  add=add, activation=activation, lite_v2=self.LITE_V2)
        for st in self.MSCB_STAGES:
            c = ch[4 - st]
            self.add_module(f"mscb{st}", MSCBLayer(c, c, n=1, stride=1,
                                                   **mk))
        for st in (3, 2, 1, 0):
            light = st in self.LIGHT_STAGES
            self.add_module(f"eucb{st}", EUCB(
                ch[3 - st], ch[4 - st], kernel_size=3, stride=1,
                activation=activation, light=light,
                shuffle=self.EUCB_SHUFFLE if light else True,
                shuffle_times=self.EUCB_SHUFFLE_TIMES))
        if self.USE_LGAG:
            gates = [(st, ch[4 - st]) for st in (3, 2, 1, 0)]
            if self.LGAG4:
                gates.append((4, ch[0]))
            for st, c in gates:
                self.add_module(f"lgag{st}", LGAG(
                    c, c, c // 2, kernel_size=lgag_ks, groups=c // 2,
                    activation=activation))
        if self.USE_CBAM:
            for st in (4, 3, 2, 1, 0):
                self.add_module(f"cab{st}", CAB(ch[4 - st]))
            self.sab = SAB()

    def _stage(self, kind, st):
        return self._modules.get(f"{kind}{st}")

    def _cbam(self, st, d):
        if not self.USE_CBAM:
            return d
        d = self._stage("cab", st)(d) * d
        return self.sab(d) * d

    def forward(self, x, skips):
        outs = []
        if self.LGAG4:
            d = skips[-1] + self.lgag4(x, skips[-1])
            d = skips[-1] + d
        else:
            d = self._cbam(4, x)
        if 4 in self.MSCB_STAGES:
            d = self.mscb4(d)
        outs.append(d)
        for st in (3, 2, 1, 0):
            skip = skips[-(5 - st)]
            d = self._stage("eucb", st)(d, skip.shape[-1])
            if self.USE_LGAG:
                d = d + self._stage("lgag", st)(d, skip)
            else:
                d = d + skip
            if not self.LGAG4:  # the Final variant has no CBAM at all
                d = self._cbam(st, d)
            if st in self.MSCB_STAGES:
                d = self._stage("mscb", st)(d)
            outs.append(d)
        return outs if self.RETURN_ALL else outs[-1]


class EMCAD(EMCADBase):
    """The full decoder."""


class EMCADNoInit(EMCADBase):
    """EMCAD without the reference's weight-init calls: the same
    forward."""


class EMCADF1(EMCADBase):
    """EMCAD returning only the finest stage."""

    RETURN_ALL = False


class EMCADTest(EMCADBase):
    """Lite-v2: grouped pointwise convs, repeated shuffles, every EUCB
    light."""

    LITE_V2 = True
    EUCB_SHUFFLE_TIMES = 3
    LIGHT_STAGES = (3, 2, 1, 0)
    EUCB_SHUFFLE = True


class EMCADv1_6(EMCADBase):
    """The flagship decoder: light EUCBs at stages 3 and 1, MSCBs at
    stages 4 and 0 only."""

    MSCB_STAGES = (4, 0)
    LIGHT_STAGES = (3, 1)


class EMCADv1_6_noASG(EMCADv1_6):
    USE_LGAG = False


class EMCADv1_6_noCBAM(EMCADv1_6):
    USE_CBAM = False


class EMCADv1_6_noMMLP(EMCADv1_6):
    MSCB_STAGES = ()


class EMCADv1_6_Final(EMCADv1_6):
    """Light EUCBs without shuffle, a gate at the coarsest stage, no
    CBAM."""

    MSCB_STAGES = (4, 0)
    USE_CBAM = False
    LGAG4 = True
    EUCB_SHUFFLE = False
