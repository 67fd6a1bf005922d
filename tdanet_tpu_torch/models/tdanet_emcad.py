"""The EMCAD-era TDANet family: EMCAD-integrated and TransXNet-flavoured
variants (counterpart of ``tdanet_tpu/models/tdanet_emcad.py``).

They share TDANetBest's masking pipeline with GroupNorm in place of GlobLN
(lattice pad -> frame encoder -> GroupNorm -> bottleneck -> shared-weight
``Recurrent`` block -> PReLU + 1x1 mask head -> ReLU mask x encoder
features -> overlap-add decoder -> trim). The U-block
(:class:`UConvBlockEra`) swaps in:

- downsampling: IDConv (``DynamicConv1d``), the fixed-length
  ``FCDyConv1d``, or the depthwise K5 ConvNorm pyramid;
- the global attention: MLP only, the unfixed MHA, OSRA with a learned
  relative-position bias, or a whole TransXNet ``Block1D``;
- fusion: inject-sum or per-scale ``CrossAttention1D`` mixers;
- an EMCAD decoder over (global, fused scales) before the LA expansion,
  or as the block's output (``emcad_direct``);
- the last-layer fusion: LA or LAOpt1-5.

``feat_len`` (the encoder's frames of the padded input,
:func:`feat_len_for`) sizes the RPE tables and FCDyConv's pooling, so
those models run at that length only; a forward at another length raises,
as in the JAX package. #1 runs at every GroupNorm depthwise site in its
range by the components' rule: the conv pyramid, the LAs' three
ConvNorms, LAOpt1-3's ``global_act``, MSDC's and EUCB's depthwise convs,
and OSRA's K1 ``sr`` conv.

A model's ``forward(wav, per_utterance=False, *, training=False,
generator=None, compute_dtype=None)`` takes what the JAX ``apply`` takes,
and the port's ``per_utterance``; there is no early exit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tdanet_tpu_torch.models import emcad as em
from tdanet_tpu_torch.models import transxnet as tx
from tdanet_tpu_torch.models.base import BaseModel, register_model, \
    warn_unused_kwargs
from tdanet_tpu_torch.models.components import (
    FFN, LA, ConvNorm, ConvNormAct, DilatedConvNorm, GroupNorm1,
    MultiHeadAttentionModule, Recurrent)
from tdanet_tpu_torch.ops import basic as ops


def feat_len_ladder(feat_len, depth):
    """Scale lengths fine -> coarse: L0 = feat_len, L_{k+1} = (L_k+1)//2."""
    out = [feat_len]
    for _ in range(depth - 1):
        out.append((out[-1] + 1) // 2)
    return out


def feat_len_for(T, enc_kernel_ms, sample_rate):
    """The scale-0 frames of an input of ``T`` samples: the static
    ``feat_len`` the era models' RPE tables and FCDyConv need at
    construction (the lattice pad, then the stride-K/4 framed encoder with
    K//2 padding; ``enc_kernel_ms`` in milliseconds, as in the configs)."""
    K = enc_kernel_ms * sample_rate // 1000
    S = K // 4
    rest = K - (S + T % K) % K
    T_p = T + (rest if rest > 0 else 0) + 2 * (K - S)
    return (T_p + 2 * (K // 2) - K) // S + 1


def _gate(x_l, x_g, global_act):
    """x_l * nearest-upsampled sigmoid(global_act(x_g))."""
    return x_l * ops.interpolate_nearest(torch.sigmoid(global_act(x_g)),
                                         x_l.shape[-1])


# ---------------------------------------------------------------------------
# LAOpt research fusions (the last layer of the laopt variants)
# ---------------------------------------------------------------------------


class LAOpt1(nn.Module):
    """x_l * up(sigmoid(global_act(x_g))) + x_l."""

    def __init__(self, inp, oup, kernel=1, norm="gn"):
        super().__init__()
        self.global_act = ConvNorm(inp, oup, kernel,
                                   groups=inp if inp == oup else 1,
                                   bias=False, norm=norm)

    def forward(self, x_l, x_g):
        return _gate(x_l, x_g, self.global_act) + x_l


class LAOpt2(nn.Module):
    """The gate, then CAB (ratio 32) channel re-weighting; no residual."""

    RESIDUAL = False

    def __init__(self, inp, oup, kernel=1, norm="gn", ratio=32):
        super().__init__()
        self.global_act = ConvNorm(inp, oup, kernel,
                                   groups=inp if inp == oup else 1,
                                   bias=False, norm=norm)
        self.cab = em.CAB(inp, oup, ratio=ratio)

    def forward(self, x_l, x_g):
        out = _gate(x_l, x_g, self.global_act)
        out = self.cab(out) * out
        return x_l + out if self.RESIDUAL else out


class LAOpt3(LAOpt2):
    """LAOpt2 with CAB ratio 16 and a residual."""

    RESIDUAL = True

    def __init__(self, inp, oup, kernel=1, norm="gn"):
        super().__init__(inp, oup, kernel, norm, ratio=16)


class LAOpt4(nn.Module):
    """A gate from a stride-2 K3 ConvTranspose of F.pad(x_g, (0, 1)),
    sliced to the local length, then CAB (ratio 16) and a residual."""

    def __init__(self, inp, oup, kernel=1, norm="gn", use_cab=True):
        super().__init__()
        self.groups = inp if inp == oup else 1
        self.global_act = nn.ConvTranspose1d(inp, oup, 3, stride=2,
                                             groups=self.groups, bias=False)
        self.cab = em.CAB(inp, oup, ratio=16) if use_cab else None

    def forward(self, x_l, x_g):
        up = ops.conv_transpose1d(F.pad(x_g, (0, 1)), self.global_act.weight,
                                  stride=2, groups=self.groups)
        out = x_l * torch.sigmoid(up[:, :, :x_l.shape[-1]])
        if self.cab is not None:
            out = self.cab(out) * out
        return x_l + out

    @torch.no_grad()
    def init_own_(self, generator):
        w = self.global_act.weight
        bound = 1.0 / math.sqrt(w.shape[0] // self.groups * 3)
        w.uniform_(-bound, bound, generator=generator)


class LAOpt5(LAOpt4):
    """LAOpt4 without the CAB."""

    def __init__(self, inp, oup, kernel=1, norm="gn"):
        super().__init__(inp, oup, kernel, norm, use_cab=False)


_LAST_LAYERS = {"la": LA, "laopt1": LAOpt1, "laopt2": LAOpt2,
                "laopt3": LAOpt3, "laopt4": LAOpt4, "laopt5": LAOpt5}


# ---------------------------------------------------------------------------
# The global attention of the era
# ---------------------------------------------------------------------------


class GAEra(nn.Module):
    """An optional attention sublayer (none, the unfixed MHA, or OSRA with
    the block's relative-position table), then FFN (GroupNorm) or MS-FFN,
    each residual behind drop-path."""

    def __init__(self, out_chan, drop_path=0.0, attn="none", mlp="ffn",
                 mlp_drop=0.1, norm="gn", num_heads=4, sr_ratio=4):
        super().__init__()
        self.attn_kind, self.drop_path = attn, drop_path
        if attn == "mha":
            self.attn = MultiHeadAttentionModule(out_chan, 8, dropout=0.1)
        elif attn == "osra":
            self.attn = tx.Attention1D(out_chan, num_heads=num_heads,
                                       sr_ratio=sr_ratio)
        else:
            self.attn = None
        if mlp == "ffn":
            self.mlp = FFN(out_chan, out_chan * 2, drop=mlp_drop, norm=norm)
        else:
            self.mlp = tx.Mlp1D(out_chan, out_chan * 2, act="relu",
                                drop=mlp_drop)

    def forward(self, x, per_utterance=False, training=False, generator=None,
                rpe=None):
        if self.attn_kind == "mha":
            a = self.attn(x, per_utterance, training, generator)
        elif self.attn_kind == "osra":
            a = self.attn(x, training, generator, rpe)
        if self.attn is not None:
            x = x + ops.drop_path(a, generator, self.drop_path, training)
        m = self.mlp(x, training, generator)
        return x + ops.drop_path(m, generator, self.drop_path, training)


# ---------------------------------------------------------------------------
# The U-blocks
# ---------------------------------------------------------------------------


def _down(kind, C, i, lens, norm):
    """Scale i's downsampling: IDConv, FCDyConv or a depthwise ConvNorm,
    K5 stride 1 at scale 0, K5 stride 2 after."""
    stride = 1 if i == 0 else 2
    k = 2 * stride + 1 if i > 0 else 5
    if kind == "idconv":
        return tx.DynamicConv1d(C, kernel_size=k, reduction_ratio=4,
                                num_groups=2, stride=stride, act=None)
    if kind == "fcdy":
        return tx.FCDyConv1d(C, lens[max(i - 1, 0)], kernel_size=k,
                             reduction_ratio=4, num_groups=2, stride=stride,
                             act=None)
    return DilatedConvNorm(C, C, k, stride=stride, groups=C, norm=norm)


class _EraBlock(nn.Module):
    """The parts both era U-blocks share: the 1x1 projection, the
    downsampling pyramid and its pooled sum, the LA expansion with the
    reference's ``x_fused[i - 1]`` pairing, and ``res_conv``."""

    def _pyramid(self, x):
        output = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            output.append(self.spp_dw[k](output[-1]))
        coarsest = output[-1].shape[-1]
        global_f = output[-1]
        for fea in output[:-1]:
            global_f = global_f + ops.adaptive_avg_pool1d(fea, coarsest)
        return output, global_f

    def _expand(self, x_fused, residual):
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            g = x_fused[i - 1] if i == self.depth - 2 else expanded
            expanded = self.last_layer[i](x_fused[i], g)
        return ops.conv1d_module(expanded, self.res_conv) + residual


class UConvBlockEra(_EraBlock):
    """The parameterised U-block of the EMCAD era (see the module
    docstring). The quirks of the reference are kept: the first expansion
    pairs scale depth-2 with the finer scale depth-3; the EMCAD outputs
    are reversed to fine -> coarse before the expansion; ``emcad_direct``
    returns the decoder's output through ``res_conv`` with no LA."""

    def __init__(self, out_channels=128, in_channels=512,
                 upsampling_depth=5, feat_len=None, down="idconv",
                 ga=None, emcad_cls=None, emcad_kw=None, fusion="inject",
                 last="la", emcad_direct=False, norm="gn"):
        super().__init__()
        self.depth = upsampling_depth
        self.fusion, self.emcad_direct = fusion, emcad_direct
        C = in_channels
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, norm=norm)
        lens = feat_len_ladder(feat_len, upsampling_depth) if feat_len \
            else None
        self.spp_dw = nn.ModuleList([_down(down, C, i, lens, norm)
                                     for i in range(upsampling_depth)])
        self.globalatt = ga if ga is not None else GAEra(C)
        if getattr(self.globalatt, "attn_kind", "") == "osra":
            rpe_attn = self.globalatt.attn
        elif isinstance(self.globalatt, tx.Block1D):
            rpe_attn = self.globalatt.token_mixer.global_unit
        else:
            rpe_attn = None
        if rpe_attn is not None:
            self.relative_pos_enc = nn.Parameter(torch.zeros(
                1, rpe_attn.num_heads, lens[-1],
                -(-lens[-1] // rpe_attn.sr_ratio)))
        else:
            self.relative_pos_enc = None
        if fusion == "mixers":
            self.global_mixers = nn.ModuleList([
                tx.CrossAttention1D(C, num_heads=1, sr_ratio=1)
                for _ in range(upsampling_depth)])
        self.emcad = None if emcad_cls is None else emcad_cls(
            channels=[C] * upsampling_depth, feat_len=feat_len,
            **(emcad_kw or {}))
        self.last_layer = nn.ModuleList([
            _LAST_LAYERS[last](C, C, 5, norm=norm)
            for _ in range(upsampling_depth - 1)])
        self.res_conv = nn.Conv1d(C, out_channels, 1)

    @torch.no_grad()
    def init_own_(self, generator):
        if self.relative_pos_enc is not None:
            self.relative_pos_enc.zero_()

    def forward(self, x, per_utterance=False, training=False,
                generator=None):
        output, global_f = self._pyramid(x)
        global_f = self.globalatt(global_f, per_utterance, training,
                                  generator, rpe=self.relative_pos_enc)
        if self.fusion == "mixers":
            x_fused = [mixer(o, global_f, training, generator)
                       for mixer, o in zip(self.global_mixers, output)]
        else:
            x_fused = [ops.interpolate_nearest(global_f, o.shape[-1]) + o
                       for o in output]
        if self.emcad is not None:
            decoded = self.emcad(global_f, x_fused)
            if self.emcad_direct:
                return ops.conv1d_module(decoded, self.res_conv) + x
            x_fused = decoded[::-1]  # fine -> coarse
        return self._expand(x_fused, x)


class UConvBlockV14(_EraBlock):
    """v1_4's inline composition: per-scale CAB and SAB, a bottom-up chain
    of light EUCBs and LGAG3 gates (lite-v2 flavours; the gates' groups
    256 fixed, as in the reference) building x_fused, each step's MSCB
    output appended but NOT carried into the next step, then the LA
    expansion."""

    def __init__(self, out_channels=128, in_channels=512,
                 upsampling_depth=5, feat_len=None, norm="gn"):
        super().__init__()
        self.depth = upsampling_depth
        C, n = in_channels, upsampling_depth - 1
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, norm=norm)
        self.spp_dw = nn.ModuleList([_down("idconv", C, i, None, norm)
                                     for i in range(upsampling_depth)])
        self.cab = nn.ModuleList([em.CAB(C) for _ in range(upsampling_depth)])
        self.sab = em.SAB()
        self.globalatt = GAEra(C, drop_path=0.1, attn="none", mlp="ffn",
                               mlp_drop=0.1, norm=norm)
        self.last_layer = nn.ModuleList([LA(C, C, 5, norm=norm)
                                         for _ in range(n)])
        self.eucb_layer = nn.ModuleList([
            em.EUCB(C, C, 3, 1, activation="prelu", light=True,
                    shuffle_times=3) for _ in range(n)])
        self.lgag_layer = nn.ModuleList([
            em.LGAG3(C, C, C, kernel_size=3, groups=256, activation="prelu")
            for _ in range(n)])
        self.mscb_layer = nn.ModuleList([
            em.MSCBLayer(C, C, n=1, stride=1, kernel_sizes=[1, 3, 5],
                         expansion_factor=0.5, activation="prelu",
                         lite_v2=True) for _ in range(n)])
        self.lgag_0 = em.LGAG(C, C, C, kernel_size=3, groups=256,
                              activation="prelu")
        self.res_conv = nn.Conv1d(C, out_channels, 1)

    def forward(self, x, per_utterance=False, training=False,
                generator=None):
        output, global_f = self._pyramid(x)
        global_f = self.globalatt(global_f, per_utterance, training,
                                  generator)
        x_fused = [self.lgag_0(global_f, output[-1])]
        tmp_x = output[-1]
        for idx in range(self.depth - 1):
            skip = output[self.depth - 2 - idx]
            L = skip.shape[-1]
            bottom = self.eucb_layer[idx](tmp_x, L)
            tmp_x = self.lgag_layer[idx](
                ops.interpolate_nearest(global_f, L), skip, bottom) + skip
            tmp_x = self.cab[idx](tmp_x) * tmp_x
            tmp_x = self.sab(tmp_x) * tmp_x
            x_fused.append(self.mscb_layer[idx](tmp_x))
        return self._expand(x_fused[::-1], x)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


class _EraTDANet(BaseModel):
    """The family's shared pipeline; the class attributes choose the
    U-block."""

    DOWN = "idconv"
    EMCAD_CLS = None
    EMCAD_KW = dict(expansion_factor=0.5, activation="prelu")
    EMCAD_DIRECT = False
    GA_KW = dict(drop_path=0.0, attn="none", mlp="ffn", mlp_drop=0.0)
    FUSION = "inject"
    LAST = "la"
    BLOCK_CLS = None

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=5, enc_kernel_size=21, num_sources=2,
                 sample_rate=16000, feat_len=None, remat=False, **unused):
        warn_unused_kwargs(type(self).__name__, unused)
        super().__init__(sample_rate=sample_rate)
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.num_blocks = num_blocks
        self.upsampling_depth = upsampling_depth
        self.enc_kernel_size_ms = enc_kernel_size
        self.enc_kernel_size = K = enc_kernel_size * sample_rate // 1000
        self.enc_num_basis = C = K // 2 + 1
        self.num_sources = num_sources
        self.feat_len = feat_len
        # the stride lattice that arbitrary-length inputs are padded to
        self.lcm = abs(K // 4 * 4 ** upsampling_depth) \
            // math.gcd(K // 4, 4 ** upsampling_depth)
        if self.BLOCK_CLS is not None:
            block = self.BLOCK_CLS(out_channels, in_channels,
                                   upsampling_depth, feat_len=feat_len)
        else:
            block = UConvBlockEra(
                out_channels, in_channels, upsampling_depth,
                feat_len=feat_len, down=self.DOWN, ga=self._ga(in_channels),
                emcad_cls=self.EMCAD_CLS, emcad_kw=self.EMCAD_KW,
                fusion=self.FUSION, last=self.LAST,
                emcad_direct=self.EMCAD_DIRECT)
        self.encoder = nn.Conv1d(1, C, K, stride=K // 4, padding=K // 2,
                                 bias=False)
        self.ln = GroupNorm1(C)
        self.bottleneck = nn.Conv1d(C, out_channels, 1)
        self.sm = Recurrent(out_channels, in_channels, upsampling_depth,
                            num_blocks, remat=remat, block=block)
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(out_channels, num_sources * C, 1))
        self.decoder = nn.ConvTranspose1d(C * num_sources, num_sources, K,
                                          stride=K // 4, padding=K // 2,
                                          bias=False)

    def _ga(self, in_channels):
        return GAEra(in_channels, norm="gn", **self.GA_KW)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        K, C = self.enc_kernel_size, self.enc_num_basis
        ops.xavier_init_(self.encoder.weight, 1, C, K, generator)
        ops.xavier_init_(self.decoder.weight, C * self.num_sources,
                         self.num_sources, K, generator)
        return self

    def forward(self, wav, per_utterance=False, *, training=False,
                generator=None, compute_dtype=None):
        """wav (T,), (B, T) or (B, 1, T) -> estimates (n_src, T) or
        (B, n_src, T), in ``compute_dtype`` or else the parameters' dtype.
        ``per_utterance=True`` separates every row as if it were alone
        (the unfixed MHA's batch-axis collapse); ``training=True`` turns on
        dropout and drop-path, with masks from ``generator``."""
        was_one_d = wav.ndim == 1
        if was_one_d:
            wav = wav[None]
        if wav.ndim == 3:
            wav = wav.squeeze(1)
        wav = wav.to(compute_dtype or self.decoder.weight.dtype)
        K = self.enc_kernel_size
        S = K // 4
        x, rest = ops.pad_signal(wav, K, S)
        s = ops.conv1d(x[:, None, :], self.encoder.weight, stride=S,
                       padding=K // 2)
        x = ops.conv1d(self.ln(s), self.bottleneck.weight,
                       self.bottleneck.bias)
        x = self.sm(x, per_utterance=per_utterance, training=training,
                    generator=generator)
        act, head = self.mask_net
        x = ops.conv1d(ops.prelu(x, act.weight), head.weight, head.bias)
        B = x.shape[0]
        x = F.relu(x.reshape(B, self.num_sources, self.enc_num_basis, -1))
        x = (x * s[:, None]).reshape(B, self.num_sources * self.enc_num_basis,
                                     -1)
        est = ops.conv_transpose1d(x, self.decoder.weight, stride=S,
                                   padding=K // 2)
        est = est[:, :, K - S: est.shape[-1] - (rest + K - S)]
        return est[0] if was_one_d else est

    def get_model_args(self):
        return {"out_channels": self.out_channels,
                "in_channels": self.in_channels,
                "num_blocks": self.num_blocks,
                "upsampling_depth": self.upsampling_depth,
                "enc_kernel_size": self.enc_kernel_size_ms,
                "num_sources": self.num_sources,
                "sample_rate": self._sample_rate,
                "feat_len": self.feat_len}


@register_model
class TDANetEMCAD_v1(_EraTDANet):
    """IDConv down + the EMCADNoInit decoder."""
    EMCAD_CLS = em.EMCADNoInit


@register_model
class TDANetEMCADv1_3(_EraTDANet):
    """IDConv + the lite-v2 EMCADTest decoder."""
    EMCAD_CLS = em.EMCADTest
    GA_KW = dict(drop_path=0.1, attn="none", mlp="ffn", mlp_drop=0.1)


@register_model
class TDANetEMCADv1_4(_EraTDANet):
    """The inline LGAG3 composition (:class:`UConvBlockV14`); its gates'
    groups are 256, so in_channels must be a multiple of 256."""
    BLOCK_CLS = UConvBlockV14


@register_model
class TDANetEMCADv1_5(_EraTDANet):
    """IDConv + the full EMCAD."""
    EMCAD_CLS = em.EMCAD
    GA_KW = dict(drop_path=0.1, attn="none", mlp="ffn", mlp_drop=0.1)


@register_model
class TDANetEMCADv1_6(_EraTDANet):
    """The family's flagship: IDConv + EMCADv1_6."""
    EMCAD_CLS = em.EMCADv1_6


@register_model
class TDANetEMCADv1_6_Final(_EraTDANet):
    """FCDyConv down + EMCADv1_6_Final."""
    DOWN = "fcdy"
    EMCAD_CLS = em.EMCADv1_6_Final


@register_model
class TDANetEMCADv1_6_noIDConv(_EraTDANet):
    """The depthwise ConvNorm pyramid + EMCADv1_6."""
    DOWN = "conv"
    EMCAD_CLS = em.EMCADv1_6


@register_model
class TDANetEMCADv1_6_FCDyConv(_EraTDANet):
    """FCDyConv down + EMCADv1_6."""
    DOWN = "fcdy"
    EMCAD_CLS = em.EMCADv1_6


@register_model
class TDANetEMCADv1_6_LAOpt1(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6
    LAST = "laopt1"


@register_model
class TDANetEMCADv1_6_noASG(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noASG


@register_model
class TDANetEMCADv1_6_noCBAM(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noCBAM


@register_model
class TDANetEMCADv1_6_noMMLP(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noMMLP


@register_model
class TDANetEMCADv1_6_noCBAM_laopt3(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noCBAM
    LAST = "laopt3"


@register_model
class TDANetEMCADv1_6_noCBAM_laopt4(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noCBAM
    LAST = "laopt4"


@register_model
class TDANetEMCADv1_6_noCBAM_laopt5(_EraTDANet):
    EMCAD_CLS = em.EMCADv1_6_noCBAM
    LAST = "laopt5"


@register_model
class TDANetEMCAD(_EraTDANet):
    """The depthwise pyramid + the full EMCAD (expansion 0.25)."""
    DOWN = "conv"
    EMCAD_CLS = em.EMCAD
    EMCAD_KW = dict(expansion_factor=0.25, activation="prelu")
    GA_KW = dict(drop_path=0.1, attn="none", mlp="ffn", mlp_drop=0.1)


@register_model
class TDANetEMCADF1(_EraTDANet):
    """The depthwise pyramid + EMCADF1 as the block's direct output; the
    GA keeps the unfixed MHA."""
    DOWN = "conv"
    EMCAD_CLS = em.EMCADF1
    EMCAD_DIRECT = True
    GA_KW = dict(drop_path=0.1, attn="mha", mlp="ffn", mlp_drop=0.1)


@register_model
class TDANetDynamicDownsample(_EraTDANet):
    """IDConv downsampling, no EMCAD."""


@register_model
class TDANetGateOSRA(_EraTDANet):
    """OSRA GA (4 heads, sr_ratio 1) with the learned relative-position
    bias; needs ``feat_len``."""
    DOWN = "conv"
    GA_KW = dict(drop_path=0.1, attn="osra", mlp="ffn", mlp_drop=0.1,
                 num_heads=4, sr_ratio=1)


@register_model
class TDANetChannelFusion(_EraTDANet):
    """IDConv down + LAOpt2 CAB-fusion last layers (CAB ratio 32); the GA
    keeps the unfixed MHA."""
    GA_KW = dict(drop_path=0.1, attn="mha", mlp="ffn", mlp_drop=0.1)
    LAST = "laopt2"


@register_model
class TDANetMSFFN(_EraTDANet):
    """The coarse-scale transformer is a whole TransXNet ``Block1D``
    (D-Mixer with OSRA at sr_ratio 4 + MS-FFN) with the learned
    relative-position bias; needs ``feat_len``."""
    DOWN = "conv"

    def _ga(self, in_channels):
        return tx.Block1D(in_channels, kernel_size=3, num_groups=2,
                          num_heads=4, sr_ratio=4, mlp_ratio=4, act="relu",
                          drop=0.1, drop_path=0.1,
                          layer_scale_init_value=1e-5)


@register_model
class TDANetTranXNet(_EraTDANet):
    """Per-scale CrossAttention1D mixers in place of the inject-sum."""
    DOWN = "conv"
    FUSION = "mixers"
    GA_KW = dict(drop_path=0.1, attn="none", mlp="ffn", mlp_drop=0.1)
