"""TDANet building blocks as ``nn.Module``s (counterpart of
``tdanet_tpu/models/components.py``).

Module and parameter names follow the JAX package's parameter tree, so a
block's ``state_dict()`` keys equal its flat JAX keys. Every depthwise
ConvNorm in kernel #1's range runs the fused conv + GlobLN kernel, and its
backward kernel where a gradient is wanted, with either norm
(:class:`ConvNorm` states the rule); the other ConvNorms are a conv and
the plain norm.

Norm flavours: ``"gln"`` is GlobLN with parameters gamma and beta,
``"gn"`` GroupNorm(1, C, eps=1e-8) with weight and bias. Their statistics
are the same (one pass, eps inside the rsqrt); only the names differ.

Training mode (``training=True`` with a ``torch.Generator``) places
dropout and drop-path where the JAX package does, at the rates each module
is built with (0.1 unless a model says otherwise): FFN after the ReLU and
after fc2; the attention weights and the attention's residual branch;
drop-path on both GA sublayers. At inference they are the identity.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (dw_conv_glob_ln,
                                                      supports)
from tdanet_tpu_torch.ops import basic as ops
from tdanet_tpu_torch.parallel import collectives


def _untraced():
    """A context in which new tensors are real tensors, also inside
    ``torch.export``'s tracing (no fake tensors, nothing recorded)."""
    stack = contextlib.ExitStack()
    if torch.compiler.is_exporting():
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.fx.experimental.proxy_tensor import \
            disable_proxy_modes_tracing
        stack.enter_context(unset_fake_temporarily())
        stack.enter_context(disable_proxy_modes_tracing())
    return stack


@functools.cache
def _pe_table(T, C, dtype, device):
    """The attention's (T, C) sinusoidal table, one per length, width,
    dtype and device, never written and never freed: a captured CUDA
    graph reads the table its capture saw and holds no reference to it,
    so the table must outlive every graph (an evicted one would be
    reused memory that a replay reads as its table). It is a real tensor
    even when ``torch.export`` traces the first call (:func:`_untraced`):
    a program keeps it as one constant on its device, with no host copy
    when it runs, and no module holds a tensor made during a trace."""
    with _untraced():
        return ops.sinusoidal_pe(T, C, dtype, device)


class GlobLN(nn.Module):
    """Global LayerNorm parameters (gamma, beta) and its plain forward."""

    eps = 1e-8

    def __init__(self, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def affine(self):
        return self.gamma, self.beta

    def forward(self, x):
        return ops.glob_ln(x, self.gamma, self.beta)


class GroupNorm1(nn.Module):
    """nn.GroupNorm(1, C, eps) parameters (weight, bias) and its plain
    forward; eps 1e-8 unless given."""

    def __init__(self, channels, eps=1e-8):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def affine(self):
        return self.weight, self.bias

    def forward(self, x):
        return ops.group_norm1(x, self.weight, self.bias, eps=self.eps)


def make_norm(channels, norm):
    """The norm of a flavour: GlobLN for "gln", GroupNorm1 for "gn"."""
    if norm == "gln":
        return GlobLN(channels)
    if norm == "gn":
        return GroupNorm1(channels)
    raise ValueError(norm)


def routes_to_kernel(conv, stride, padding):
    """The one rule for #1's sites: a conv that a global norm follows runs
    ``dw_conv_glob_ln`` when it is depthwise (groups == n_in == n_out), its
    padding is 'same' ((K-1)//2) and ``supports(K, stride)`` holds (K odd
    and at most 7, stride 1 or 2). Fixed at construction from the site's
    shape alone."""
    K = conv.kernel_size[0]
    return (conv.groups == conv.in_channels == conv.out_channels
            and conv.dilation[0] == 1 and padding == (K - 1) // 2
            and supports(K, stride))


def conv_then_norm(x, conv, norm, stride, padding, on_kernel):
    """conv (its weight, bias or none) then ``norm`` (GlobLN or GroupNorm1,
    with its own eps) on (B, C, T): through #1 where ``on_kernel`` (from
    :func:`routes_to_kernel`), the norm's affine and eps passed as the
    kernel's gamma, beta and eps; else ``ops.conv1d`` and the plain norm.
    A kernel that fails raises: no site gives way to the plain path at
    run time."""
    if on_kernel:
        return dw_conv_glob_ln(
            x.transpose(1, 2), conv.weight, conv.bias, *norm.affine(),
            stride=stride, K=conv.kernel_size[0],
            eps=norm.eps).transpose(1, 2)
    return norm(ops.conv1d(x, conv.weight, conv.bias, stride=stride,
                           padding=padding, groups=conv.groups))


class ConvNorm(nn.Module):
    """Conv1d ('same' padding) + a global norm: GlobLN (``norm="gln"``,
    parameters gamma and beta) or GroupNorm(1, C) (``norm="gn"``, weight and
    bias), both at eps 1e-8.

    The route is :func:`routes_to_kernel`'s rule, fixed at construction
    (``on_kernel``): a depthwise 'same' site in #1's range runs
    ``dw_conv_glob_ln`` for either norm, with the norm's affine and eps;
    every other site is ``ops.conv1d`` and the plain norm."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, bias=True,
                 norm="gln"):
        super().__init__()
        self.stride, self.kernel = stride, kernel
        self.padding = (kernel - 1) // 2
        self.conv = nn.Conv1d(n_in, n_out, kernel, stride=stride,
                              padding=self.padding, groups=groups, bias=bias)
        self.norm = make_norm(n_out, norm)
        self.on_kernel = routes_to_kernel(self.conv, stride, self.padding)

    def forward(self, x):
        return conv_then_norm(x, self.conv, self.norm, self.stride,
                              self.padding, self.on_kernel)


class ConvNormAct(ConvNorm):
    """Conv1d + global norm + PReLU."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, norm="gln"):
        super().__init__(n_in, n_out, kernel, stride, groups, bias=True,
                         norm=norm)
        self.act = nn.PReLU()

    def forward(self, x):
        return ops.prelu(super().forward(x), self.act.weight)


class NormAct(nn.Module):
    """Global norm + PReLU."""

    def __init__(self, channels, norm="gln"):
        super().__init__()
        self.norm = make_norm(channels, norm)
        self.act = nn.PReLU()

    def forward(self, x):
        return ops.prelu(self.norm(x), self.act.weight)


class DilatedConvNorm(ConvNorm):
    """The pyramid's depthwise conv + norm, with bias (dilation 1, the only
    one the TDANet models use)."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, norm="gln"):
        super().__init__(n_in, n_out, kernel, stride, groups, bias=True,
                         norm=norm)


class DilatedSeparableConvNorm(nn.Module):
    """Depthwise conv -> pointwise conv -> norm (TDANet's "conv-pool"
    branch). The norm follows the pointwise conv, so this is not kernel
    #1's function: two cuDNN convs and the plain norm."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, norm="gn"):
        super().__init__()
        self.stride, self.padding = stride, (kernel - 1) // 2
        self.dw_conv = nn.Conv1d(n_in, n_out, kernel, stride=stride,
                                 padding=self.padding, groups=groups)
        self.pw_conv = nn.Conv1d(n_in, n_out, 1)
        self.norm = make_norm(n_out, norm)

    def forward(self, x):
        dw, pw = self.dw_conv, self.pw_conv
        y = ops.conv1d(x, dw.weight, dw.bias, stride=self.stride,
                       padding=self.padding, groups=dw.groups)
        return self.norm(ops.conv1d(y, pw.weight, pw.bias))


class FFN(nn.Module):
    """1x1 ConvNorm -> depthwise k5 conv -> ReLU -> dropout -> 1x1 ConvNorm
    -> dropout."""

    def __init__(self, in_features, hidden, drop=0.1, norm="gln"):
        super().__init__()
        self.fc1 = ConvNorm(in_features, hidden, 1, bias=False, norm=norm)
        self.dwconv = nn.Conv1d(hidden, hidden, 5, padding=2, groups=hidden)
        self.fc2 = ConvNorm(hidden, in_features, 1, bias=False, norm=norm)
        self.drop = drop

    def forward(self, x, training=False, generator=None, dp_group=None):
        x = self.fc1(x)
        x = ops.conv1d(x, self.dwconv.weight, self.dwconv.bias, padding=2,
                       groups=self.dwconv.groups)
        x = ops.dropout(F.relu(x), generator, self.drop, training, dp_group)
        return ops.dropout(self.fc2(x), generator, self.drop, training,
                           dp_group)


class MultiHeadAttentionModule(nn.Module):
    """The TDANet attention sublayer, in the reference family's three
    flavours:

    - the default (TDANetBest, TDANetYang): the (B, T, C) input runs
      through batch_first=False attention, so it attends over the BATCH
      axis with T as the batch, and the residual is the attention output
      added to itself. For one utterance that is softmax over one element,
      and the output collapses exactly to out_proj(v_proj(x)).
      ``per_utterance=True`` applies that collapse to every row: each row
      then gets what it would alone, which is how a batch of independent
      utterances is separated;
    - ``batch_first=True`` with ``self_residual=True`` (TDANetOld):
      attention over T within each row, the self-added residual;
    - ``fixed=True``, shorthand for batch_first=True and
      self_residual=False (TDANetMultRes): attention over T, the residual
      ``normed input + pe + attention output``.

    In training the attention weights and the residual branch are dropped
    at ``dropout``, and the one-utterance collapse is not taken: at B = 1
    the weights of the one element are dropped too, as the JAX package
    does.
    """

    def __init__(self, channels, n_head=8, fixed=False, dropout=0.1,
                 batch_first=None, self_residual=None):
        super().__init__()
        self.n_head = n_head
        self.batch_first = fixed if batch_first is None else batch_first
        self.self_residual = (not fixed) if self_residual is None \
            else self_residual
        self.dropout = dropout
        self.attn_in_norm = nn.LayerNorm(channels)
        # parameter holder only: its forward is not the reference's math
        self.attn = nn.MultiheadAttention(channels, n_head)
        self.norm = nn.LayerNorm(channels)

    @property
    def fixed(self):
        """The repaired flavour: attention over T, the true residual."""
        return self.batch_first and not self.self_residual

    def _pos_enc(self, T, C, like):
        return _pe_table(T, C, like.dtype, like.device)

    def forward(self, x, per_utterance=False, training=False,
                generator=None, dp_group=None):
        B, C, T = x.shape
        a = self.attn
        out = ops.layer_norm(x.transpose(1, 2), self.attn_in_norm.weight,
                             self.attn_in_norm.bias)
        out = out + self._pos_enc(T, C, out)
        drop = dict(dropout_rate=self.dropout, generator=generator,
                    training=training, dp_group=dp_group)
        _, world = collectives.rank_and_world(dp_group)
        if self.batch_first:  # attention over T: (T, B, C) is (L, N, E)
            q = out.transpose(0, 1)
            attn_out = ops.multi_head_attention(
                q, q, q, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                a.out_proj.bias, self.n_head, **drop).transpose(0, 1)
        elif per_utterance or (B * world == 1 and not training):
            v = F.linear(out, a.in_proj_weight[2 * C:].to(out.dtype),
                         a.in_proj_bias[2 * C:].to(out.dtype))
            attn_out = F.linear(v, a.out_proj.weight.to(out.dtype),
                                a.out_proj.bias.to(out.dtype))
        else:
            # over the batch axis: under dp_group the keys and values are
            # every rank's rows, the queries this rank's
            kv = collectives.gather_rows(out, dp_group)
            attn_out = ops.multi_head_attention(
                out, kv, kv, a.in_proj_weight, a.in_proj_bias,
                a.out_proj.weight, a.out_proj.bias, self.n_head,
                batch_axis=1, **drop)
        res = (attn_out if self.self_residual else out) + ops.dropout(
            attn_out, generator, self.dropout, training, dp_group)
        res = ops.layer_norm(res, self.norm.weight, self.norm.bias)
        return res.transpose(1, 2)


class GA(nn.Module):
    """Global attention: attention sublayer + FFN, each with a residual
    behind drop-path. ``use_attn=False`` is the MLP-only form (no ``attn``
    parameters)."""

    def __init__(self, out_chan, fixed_mha=False, drop_path=0.1,
                 attn_dropout=0.1, ffn_drop=0.1, norm="gln", mha_kwargs=None,
                 use_attn=True):
        super().__init__()
        if use_attn:
            self.attn = MultiHeadAttentionModule(
                out_chan, 8, fixed=fixed_mha, dropout=attn_dropout,
                **(mha_kwargs or {}))
        else:
            self.attn = None
        self.mlp = FFN(out_chan, out_chan * 2, drop=ffn_drop, norm=norm)
        self.drop_path = drop_path

    def forward(self, x, per_utterance=False, training=False,
                generator=None, dp_group=None):
        if self.attn is not None:
            a = self.attn(x, per_utterance, training, generator, dp_group)
            x = x + ops.drop_path(a, generator, self.drop_path, training,
                                  dp_group)
        m = self.mlp(x, training, generator, dp_group)
        return x + ops.drop_path(m, generator, self.drop_path, training,
                                 dp_group)


class LA(nn.Module):
    """Local/global fusion:
    local_emb(x_l) * sigmoid(up(global_act(x_g))) + up(global_emb(x_g)),
    with nearest upsampling. All three embeddings are depthwise when
    inp == oup."""

    def __init__(self, inp, oup, kernel=1, norm="gln"):
        super().__init__()
        groups = inp if inp == oup else 1
        self.local_embedding = ConvNorm(inp, oup, kernel, groups=groups,
                                        bias=False, norm=norm)
        self.global_embedding = ConvNorm(inp, oup, kernel, groups=groups,
                                         bias=False, norm=norm)
        self.global_act = ConvNorm(inp, oup, kernel, groups=groups,
                                   bias=False, norm=norm)

    def forward(self, x_l, x_g):
        T, Tg = x_l.shape[-1], x_g.shape[-1]
        local_feat = self.local_embedding(x_l)
        sig_act = torch.sigmoid(self.global_act(x_g))
        global_feat = self.global_embedding(x_g)
        if T == 2 * Tg:
            # exact x2 nearest upsample (out[i] = in[i // 2]) as a broadcast
            B, C = local_feat.shape[:2]
            out = local_feat.reshape(B, C, Tg, 2) * sig_act[..., None] \
                + global_feat[..., None]
            return out.reshape(B, C, T)
        return local_feat * ops.interpolate_nearest(sig_act, T) \
            + ops.interpolate_nearest(global_feat, T)


class UConvBlock(nn.Module):
    """Multi-scale U-shaped block: 1x1 projection -> depthwise strided
    pyramid -> pooled sum -> GA -> per-scale LA fusion -> top-down LA
    expansion -> 1x1 residual. The first expansion pairs scale depth-2
    with the FINER scale depth-3, as the reference does."""

    def __init__(self, out_channels=128, in_channels=512,
                 upsampling_depth=4, fixed_mha=False):
        super().__init__()
        self.depth = upsampling_depth
        self.proj_1x1 = ConvNormAct(out_channels, in_channels, 1)
        self.spp_dw = nn.ModuleList(
            [DilatedConvNorm(in_channels, in_channels, 5, 1,
                             groups=in_channels)]
            + [DilatedConvNorm(in_channels, in_channels, 5, stride=2,
                               groups=in_channels)
               for _ in range(1, upsampling_depth)])
        self.loc_glo_fus = nn.ModuleList(
            [LA(in_channels, in_channels) for _ in range(upsampling_depth)])
        self.globalatt = GA(in_channels, fixed_mha=fixed_mha)
        self.last_layer = nn.ModuleList(
            [LA(in_channels, in_channels, 5)
             for _ in range(upsampling_depth - 1)])
        self.res_conv = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x, per_utterance=False, training=False,
                generator=None, dp_group=None):
        return self.tail(x, *self.pyramid(x), per_utterance, training,
                         generator, dp_group)

    # The stages between the JAX package's remat landmarks (its
    # ``pyr_scale``, ``ga_out`` and ``fused_scale`` tags), which
    # ``Recurrent(remat="scales")`` checkpoints one by one. Each landmark
    # passes through ``ops.store_activation``, as in the JAX block: the
    # identity unless ``ops.act_storage`` is on in this thread.

    def pyramid_scales(self, x):
        """The projection and the depth pyramid: the depth scales (each
        stored after the whole pyramid has run, as JAX orders it)."""
        output = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            output.append(self.spp_dw[k](output[-1]))
        return [ops.store_activation(o) for o in output]

    def global_feature(self, output, per_utterance=False, training=False,
                       generator=None, dp_group=None):
        """The scales pooled to the coarsest length and summed, then GA."""
        return ops.store_activation(self.globalatt(
            self._pooled(output), per_utterance, training, generator,
            dp_group))

    def fusions(self, output, global_f, n):
        """The LA fusions of the first ``n`` scales with the global
        feature."""
        return [ops.store_activation(self.loc_glo_fus[i](output[i], global_f))
                for i in range(n)]

    def expansion(self, x_fused):
        """The top-down LA expansion over the fused scales and res_conv
        (the residual not added). It reads ``x_fused[:depth - 1]``: the
        first expansion pairs scale depth-2 with the finer depth-3."""
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            g = x_fused[i - 1] if i == self.depth - 2 else expanded
            expanded = self.last_layer[i](x_fused[i], g)
        return ops.conv1d(expanded, self.res_conv.weight, self.res_conv.bias)

    @property
    def live_fusions(self):
        """How many fusions the expansion reads: the coarsest never is."""
        return self.depth - 1

    def _pooled(self, output):
        coarsest = output[-1].shape[-1]
        global_f = output[-1]
        for fea in output[:-1]:
            global_f = global_f + ops.adaptive_avg_pool1d(fea, coarsest)
        return global_f

    def pyramid(self, x):
        """The block's first half: (the depth scales, their pooled sum at
        the coarsest length)."""
        output = self.pyramid_scales(x)
        return output, self._pooled(output)

    def tail(self, residual, output, global_f, per_utterance=False,
             training=False, generator=None, dp_group=None):
        """The block's second half: GA, LA fusion (every scale's, the
        coarsest one's too), expansion, res_conv."""
        global_f = ops.store_activation(self.globalatt(
            global_f, per_utterance, training, generator, dp_group))
        return self.expansion(self.fusions(output, global_f, self.depth)) \
            + residual


class UConvBlockInject(nn.Module):
    """The paper-topology U-block of the TDANet variant family: like
    UConvBlock without the per-scale LA fusion; the global feature is
    nearest-upsampled and ADDED to each scale (``inject="add"``) or gates
    it through a sigmoid (``inject="gate"``). The reference's quirks are
    kept:

    - ``pool="conv"`` replaces the adaptive-average-pool global branch by
      strided separable convs, applied in REVERSED index order (scale k
      goes through ``conv_pool[depth - 1 - k]``);
    - ``expand_pair``: the first expansion's global input is the finer
      scale depth-3 ("prev") or the coarsest scale depth-1 ("next");
    - ``down_stride`` is the pyramid's stride, with kernel
      2 * down_stride + 1 (16 and 33 in TDANetULayerNum: those stages are
      outside kernel #1's range and run cuDNN + the plain norm).

    Kernel #1 runs at the pyramid's stages in its range and at the three
    depthwise K5 ConvNorms of each expansion LA; the FFN's dwconv and the
    conv-pool have no norm right after a depthwise conv."""

    def __init__(self, out_channels=128, in_channels=512, upsampling_depth=4,
                 norm="gn", pool="avg", down_stride=2, fixed_mha=False,
                 drop_path=0.1, attn_dropout=0.1, ffn_drop=0.1,
                 inject="add", expand_pair="prev", mha_kwargs=None,
                 ga_use_attn=True):
        super().__init__()
        if pool not in ("avg", "conv") or inject not in ("add", "gate") \
                or expand_pair not in ("prev", "next"):
            raise ValueError(f"pool {pool!r}, inject {inject!r}, "
                             f"expand_pair {expand_pair!r}")
        self.depth = upsampling_depth
        self.pool, self.inject, self.expand_pair = pool, inject, expand_pair
        C = in_channels
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, norm=norm)
        self.spp_dw = nn.ModuleList(
            [DilatedConvNorm(C, C, 5, 1, groups=C, norm=norm)]
            + [DilatedConvNorm(C, C, 2 * down_stride + 1, stride=down_stride,
                               groups=C, norm=norm)
               for _ in range(1, upsampling_depth)])
        if pool == "conv":
            self.conv_pool = nn.ModuleList(
                [DilatedSeparableConvNorm(C, C, 5, 1, groups=C, norm=norm)]
                + [DilatedSeparableConvNorm(C, C, 2 * 2 ** i + 1,
                                            stride=2 ** i, groups=C,
                                            norm=norm)
                   for i in range(1, upsampling_depth)])
        self.globalatt = GA(C, fixed_mha=fixed_mha, drop_path=drop_path,
                            attn_dropout=attn_dropout, ffn_drop=ffn_drop,
                            norm=norm, mha_kwargs=mha_kwargs,
                            use_attn=ga_use_attn)
        self.last_layer = nn.ModuleList(
            [LA(C, C, 5, norm=norm) for _ in range(upsampling_depth - 1)])
        self.res_conv = nn.Conv1d(C, out_channels, 1)

    def forward(self, x, per_utterance=False, training=False,
                generator=None, dp_group=None):
        output = self.pyramid_scales(x)
        global_f = self.global_feature(output, per_utterance, training,
                                       generator, dp_group)
        return self.expansion(self.fusions(output, global_f, self.depth)) \
            + x

    # The stages between the JAX package's remat landmarks, as
    # UConvBlock's.

    def pyramid_scales(self, x):
        """The projection and the depth pyramid: the depth scales."""
        output = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            output.append(self.spp_dw[k](output[-1]))
        return output

    def global_feature(self, output, per_utterance=False, training=False,
                       generator=None, dp_group=None):
        """The pooled scales (conv-pool or average) summed, then GA."""
        d = self.depth
        if self.pool == "conv":
            pooled = [self.conv_pool[d - k - 1](fea)
                      for k, fea in enumerate(output)]
        else:
            coarsest = output[-1].shape[-1]
            pooled = [ops.adaptive_avg_pool1d(fea, coarsest)
                      for fea in output]
        global_f = pooled[0]
        for fea in pooled[1:]:
            global_f = global_f + fea
        return self.globalatt(global_f, per_utterance, training, generator,
                              dp_group)

    def fusions(self, output, global_f, n):
        """The global feature injected into the first ``n`` scales."""
        if self.inject == "gate":
            return [torch.sigmoid(ops.interpolate_nearest(
                global_f, o.shape[-1])) * o for o in output[:n]]
        return [ops.interpolate_nearest(global_f, o.shape[-1]) + o
                for o in output[:n]]

    def expansion(self, x_fused):
        """The top-down LA expansion and res_conv (the residual not
        added); the first expansion's global input is scale depth-3
        ("prev") or depth-1 ("next")."""
        d = self.depth
        first = d - 3 if self.expand_pair == "prev" else d - 1
        expanded = None
        for i in range(d - 2, -1, -1):
            g = x_fused[first] if i == d - 2 else expanded
            expanded = self.last_layer[i](x_fused[i], g)
        return ops.conv1d(expanded, self.res_conv.weight, self.res_conv.bias)

    @property
    def live_fusions(self):
        """How many fusions the expansion reads: all of them when the
        first expansion pairs the coarsest scale ("next")."""
        return self.depth - (self.expand_pair == "prev")


def _iteration_generator(seed, like):
    """The generator of one block iteration's dropout masks, on like's
    device, or None outside training (``seed`` None)."""
    if seed is None:
        return None
    gen = torch.Generator(device=like.device)
    gen.manual_seed(seed)
    return gen


def _draw_seed(generator, training):
    """An iteration's seed, drawn from ``generator`` before the iteration
    runs, so a recomputed iteration draws the same masks."""
    if not training:
        return None
    return int(torch.randint(2 ** 62, (), generator=generator,
                             device=generator.device))


def _recomputed(fn, *inputs):
    """``fn(*inputs)`` under non-reentrant ``torch.utils.checkpoint``: the
    inputs are kept, whatever ``fn`` saves inside is recomputed in the
    backward. Dropout masks come from generators seeded inside ``fn``, so
    the global RNG state is not kept."""
    return torch.utils.checkpoint.checkpoint(
        fn, *inputs, use_reentrant=False, preserve_rng_state=False)


class Recurrent(nn.Module):
    """One shared block applied ``_iter`` times; from the second iteration
    its input is concat_block(mixture + x). The block is ``block`` when
    given (a UConvBlockInject of the variant family, or an EMCAD-era
    block), else TDANetBest's UConvBlock of ``fixed_mha``.

    ``remat`` sets what autograd keeps of each iteration where it records
    the graph (under ``torch.no_grad`` nothing is recorded and ``remat``
    changes nothing); every policy gives the same gradients bit for bit:

    - False: everything;
    - True: the iteration's input (``torch.utils.checkpoint``,
      non-reentrant); the backward recomputes the whole iteration;
    - "scales", the JAX package's default for training: the landmarks
      that the JAX blocks tag, ``pyr_scale`` (the depth pyramid's scales),
      ``ga_out`` (GA's output) and ``fused_scale`` (the fusions the
      expansion reads), and the iteration's input. Each stage between
      them is checkpointed on its own (:func:`_recomputed`): the pyramid
      (the concat block, the projection and the depthwise pyramid), the
      pooling and GA, the fusions, and the expansion with res_conv; the
      backward recomputes each stage once, from its landmarks. The
      coarsest fusion of UConvBlock, which the expansion never reads, is
      not computed (the JAX program drops it as dead code). This holds
      for UConvBlock and UConvBlockInject, whose JAX classes tag the
      landmarks; a block without the stages (``UConvBlockEra``,
      ``UConvBlockV14``: their JAX classes tag nothing, so JAX's policy
      saves nothing named) is checkpointed whole, as under True.

    In training every iteration draws its dropout masks from a generator of
    its own, seeded from ``generator`` before the iteration starts, so a
    recomputed iteration or stage draws the same masks.

    8-bit activation storage (``ops.act_storage``, an inference study):
    the carry of every iteration after the first, and UConvBlock's scales,
    GA output and fusions, pass through ``ops.store_activation``, as the
    JAX package's landmarks do. The mode is read as the forward runs, so a
    CUDA graph or a ``torch.export`` program keeps the mode that was set
    when it was captured."""

    def __init__(self, out_channels=128, in_channels=512, upsampling_depth=4,
                 _iter=4, fixed_mha=False, remat=False, block=None):
        super().__init__()
        self.unet = block if block is not None else UConvBlock(
            out_channels, in_channels, upsampling_depth, fixed_mha=fixed_mha)
        self.iter = _iter
        self.remat = remat
        self.concat_block = nn.Sequential(
            nn.Conv1d(out_channels, out_channels, 1, groups=out_channels),
            nn.PReLU())

    @property
    def landmarked(self):
        """Whether the block runs ``remat="scales"`` between landmarks
        (else it is checkpointed whole)."""
        return hasattr(self.unet, "pyramid_scales")

    def forward(self, x, n_iter=None, per_utterance=False, training=False,
                generator=None, dp_group=None):
        """``n_iter`` overrides the iteration count (early exit: the
        weights are shared, so any depth up to the trained one is valid).
        ``dp_group``: the data-parallel process group whose ranks hold the
        rest of the batch (``parallel/collectives.py``), or None."""
        it_count = self.iter if n_iter is None else int(n_iter)
        if not 1 <= it_count <= self.iter:
            raise ValueError(
                f"n_iter must be in [1, {self.iter}], got {it_count}")
        if training and generator is None:
            raise ValueError("training needs a torch.Generator")
        remat = self.remat if torch.is_grad_enabled() else False
        if remat == "scales" and self.landmarked:
            iteration = self._iteration_scales
        elif remat:
            iteration = functools.partial(_recomputed, self._iteration)
        else:
            iteration = self._iteration
        mixture = x
        for i in range(it_count):
            x = iteration(x, mixture, i > 0, per_utterance, training,
                          _draw_seed(generator, training), dp_group)
            if i > 0:  # the carry of iterations 2.., as JAX's scan stores it
                x = ops.store_activation(x)
        return x

    def _iteration_scales(self, x, mixture, concat, per_utterance,
                          training, seed, dp_group=None):
        """One iteration under ``remat="scales"``: its four stages, each
        checkpointed, so autograd keeps the iteration's input (and the
        mixture), the scales, GA's output and the live fusions."""
        unet = self.unet

        def pyramid(carry, *mix):
            y = self._concat(mix[0] + carry) if mix else carry
            return (y, *unet.pyramid_scales(y))

        def global_feature(*scales):
            return unet.global_feature(
                list(scales), per_utterance, training,
                _iteration_generator(seed, scales[0]), dp_group)

        def fusions(global_f, *scales):
            return tuple(unet.fusions(list(scales), global_f,
                                      unet.live_fusions))

        y, *scales = _recomputed(pyramid, x, *([mixture] if concat else []))
        global_f = _recomputed(global_feature, *scales)
        fused = _recomputed(fusions, global_f, *scales)
        out = _recomputed(lambda *f: unet.expansion(list(f)), *fused)
        return out + y

    @torch.inference_mode()
    def forward_with_state(self, x, n_iter=None, per_utterance=False):
        """Inference only: the depth-``n_iter`` forward and the progressive
        separation's convergence proxy. Returns ``(out, delta)``, ``out``
        equal to ``forward(x, n_iter)`` (the same iterations) and ``delta``
        per example ``||x_d - x_{d-1}|| / (||x_d|| + 1e-8)``, the relative
        change the last iteration made. ``n_iter`` must be at least 2."""
        it_count = self.iter if n_iter is None else int(n_iter)
        if not 2 <= it_count <= self.iter:
            raise ValueError(
                f"forward_with_state needs n_iter in [2, {self.iter}] (the "
                f"delta compares the last two iterates), got {it_count}")
        mixture = x
        prev = x = self._iteration(x, mixture, False, per_utterance, False,
                                   None)
        for _ in range(it_count - 1):
            prev, x = x, ops.store_activation(self._iteration(
                x, mixture, True, per_utterance, False, None))
        dims = tuple(range(1, x.ndim))
        delta = (x - prev).square().sum(dims).sqrt() / (
            x.square().sum(dims).sqrt() + 1e-8)
        return x, delta

    @torch.inference_mode()
    def continue_forward(self, mixture, carry, n_more, depth,
                         per_utterance=False):
        """Inference only: the exact continuation of a depth-``depth``
        carry by ``n_more`` further iterations of the same body, so
        ``forward_with_state(n_iter=d)`` then ``continue_forward(n_more=m,
        depth=d)`` equals ``forward(n_iter=d + m)``. Depths beyond the
        trained one are rejected, as in ``forward``."""
        n_more, depth = int(n_more), int(depth)
        if n_more < 1 or depth < 1 or depth + n_more > self.iter:
            raise ValueError(
                f"continue_forward from depth {depth} by {n_more} leaves "
                f"n_iter range [1, {self.iter}]")
        x = carry
        for _ in range(n_more):
            x = ops.store_activation(self._iteration(
                x, mixture, True, per_utterance, False, None))
        return x

    def _iteration(self, x, mixture, concat, per_utterance, training, seed,
                   dp_group=None):
        """One iteration; its dropout masks come from a generator on x's
        device seeded with ``seed``."""
        if concat:
            x = self._concat(mixture + x)
        return self.unet(x, per_utterance, training,
                         _iteration_generator(seed, x), dp_group)

    def _concat(self, inp):
        conv, act = self.concat_block
        y = ops.conv1d(inp, conv.weight, conv.bias, groups=conv.groups)
        return ops.prelu(y, act.weight)


class _GateConvPair(nn.Sequential):
    """Depthwise k3 conv -> 1x1 conv (a reset or update gate's convs)."""

    def __init__(self, channels, kernel=3):
        super().__init__(
            nn.Conv1d(channels, channels, kernel, padding=kernel // 2,
                      groups=channels),
            nn.Conv1d(channels, channels, 1))

    def forward(self, x):
        dw, pw = self
        y = ops.conv1d(x, dw.weight, dw.bias, padding=dw.padding[0],
                       groups=dw.groups)
        return ops.conv1d(y, pw.weight, pw.bias)


class GatedRecurrent(nn.Module):
    """GRU-style gated recurrence around the shared block
    (TDANetGateVariant): reset and update convolution gates on (mixture,
    x), each sigmoid(GroupNorm(1, C, eps=1e-6)(conv_x(mixture) +
    conv_h(x))); an iteration's output is unet(prelu(x)) * u + mixture * r.
    The first iteration is unet(prelu(x)). ``concat_block``,
    ``output_conv_x``, ``output_conv_h`` and ``output_norm`` are parameters
    of the reference that its forward never reads; they are kept for the
    checkpoint. No iteration is checkpointed (the JAX class has no remat).
    In training every iteration's dropout masks come from a generator of
    its own, seeded from ``generator`` before the iteration."""

    def __init__(self, out_channels, block, _iter=4):
        super().__init__()
        C = out_channels
        self.unet = block
        self.iter = _iter
        self.concat_block = nn.Sequential(nn.Conv1d(C, C, 1, groups=C),
                                          nn.PReLU())
        self.reset_conv_x = _GateConvPair(C)
        self.reset_conv_h = _GateConvPair(C)
        self.update_conv_x = _GateConvPair(C)
        self.update_conv_h = _GateConvPair(C)
        self.output_conv_x = nn.Conv1d(C, C, 3, padding=1, groups=C)
        self.output_conv_h = nn.Conv1d(C, C, 3, padding=1, groups=C)
        self.reset_gate_norm = GroupNorm1(C, eps=1e-6)
        self.update_gate_norm = GroupNorm1(C, eps=1e-6)
        self.output_norm = GroupNorm1(C, eps=1e-6)
        self.in_act = nn.PReLU()

    def forward(self, x, per_utterance=False, training=False,
                generator=None, dp_group=None):
        if training and generator is None:
            raise ValueError("training needs a torch.Generator")
        mixture = x
        x = self._unet(x, per_utterance, training, generator, dp_group)
        for _ in range(1, self.iter):
            r = torch.sigmoid(self.reset_gate_norm(
                self.reset_conv_x(mixture) + self.reset_conv_h(x)))
            u = torch.sigmoid(self.update_gate_norm(
                self.update_conv_x(mixture) + self.update_conv_h(x)))
            h = self._unet(x, per_utterance, training, generator, dp_group)
            x = h * u + mixture * r
        return x

    def _unet(self, x, per_utterance, training, generator, dp_group):
        gen = _iteration_generator(_draw_seed(generator, training), x)
        return self.unet(ops.prelu(x, self.in_act.weight), per_utterance,
                         training, gen, dp_group)
