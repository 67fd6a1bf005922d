"""TDANet building blocks as ``nn.Module``s (counterpart of
``tdanet_tpu/models/components.py``).

Module and parameter names follow the JAX package's parameter tree, so a
block's ``state_dict()`` keys equal its flat JAX keys. Every depthwise
ConvNorm (groups == channels) runs the fused conv + GlobLN kernel, and its
backward kernel where a gradient is wanted; the dense ones are a conv and
``ops.glob_ln``.

Training mode (``training=True`` with a ``torch.Generator``) places
dropout and drop-path where the JAX package does, at its fixed rates of
0.1: FFN after the ReLU and after fc2; the attention weights and the
attention's residual branch; drop-path on both GA sublayers. At inference
they are the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import dw_conv_glob_ln
from tdanet_tpu_torch.ops import basic as ops


class GlobLN(nn.Module):
    """Global LayerNorm parameters (gamma, beta) and its plain forward."""

    def __init__(self, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ops.glob_ln(x, self.gamma, self.beta)


class GroupNorm1(nn.Module):
    """nn.GroupNorm(1, C, eps=1e-8) parameters (weight, bias) and its plain
    forward."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ops.group_norm1(x, self.weight, self.bias)


class ConvNorm(nn.Module):
    """Conv1d ('same' padding) + a global norm: GlobLN (``norm="gln"``,
    parameters gamma and beta) or GroupNorm(1, C) (``norm="gn"``, weight and
    bias). Only the depthwise GlobLN form runs the fused kernel."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1, bias=True,
                 norm="gln"):
        super().__init__()
        if norm not in ("gln", "gn"):
            raise ValueError(norm)
        self.stride, self.kernel = stride, kernel
        self.padding = (kernel - 1) // 2
        self.depthwise = groups == n_in == n_out and norm == "gln"
        self.conv = nn.Conv1d(n_in, n_out, kernel, stride=stride,
                              padding=self.padding, groups=groups, bias=bias)
        self.norm = GlobLN(n_out) if norm == "gln" else GroupNorm1(n_out)

    def forward(self, x):
        conv, norm = self.conv, self.norm
        if self.depthwise:
            return dw_conv_glob_ln(
                x.transpose(1, 2), conv.weight, conv.bias, norm.gamma,
                norm.beta, stride=self.stride, K=self.kernel).transpose(1, 2)
        return norm(ops.conv1d(x, conv.weight, conv.bias, stride=self.stride,
                               padding=self.padding, groups=conv.groups))


class ConvNormAct(ConvNorm):
    """Conv1d + GlobLN + PReLU."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1):
        super().__init__(n_in, n_out, kernel, stride, groups, bias=True)
        self.act = nn.PReLU()

    def forward(self, x):
        return ops.prelu(super().forward(x), self.act.weight)


class DilatedConvNorm(ConvNorm):
    """The pyramid's depthwise conv + GlobLN, with bias (dilation 1, the
    only one TDANetBest uses)."""

    def __init__(self, n_in, n_out, kernel, stride=1, groups=1):
        super().__init__(n_in, n_out, kernel, stride, groups, bias=True)


class FFN(nn.Module):
    """1x1 ConvNorm -> depthwise k5 conv -> ReLU -> dropout -> 1x1 ConvNorm
    -> dropout."""

    def __init__(self, in_features, hidden, drop=0.1):
        super().__init__()
        self.fc1 = ConvNorm(in_features, hidden, 1, bias=False)
        self.dwconv = nn.Conv1d(hidden, hidden, 5, padding=2, groups=hidden)
        self.fc2 = ConvNorm(hidden, in_features, 1, bias=False)
        self.drop = drop

    def forward(self, x, training=False, generator=None):
        x = self.fc1(x)
        x = ops.conv1d(x, self.dwconv.weight, self.dwconv.bias, padding=2,
                       groups=self.dwconv.groups)
        x = ops.dropout(F.relu(x), generator, self.drop, training)
        return ops.dropout(self.fc2(x), generator, self.drop, training)


class MultiHeadAttentionModule(nn.Module):
    """TDANetBest's attention sublayer. By default it has the reference
    checkpoint's two quirks:

    - the (B, T, C) input runs through batch_first=False attention, so it
      attends over the BATCH axis with T as the batch. For one utterance
      that is softmax over one element, and the output collapses exactly
      to out_proj(v_proj(x)). ``per_utterance=True`` applies that collapse
      to every row: each row then gets what it would alone, which is how
      a batch of independent utterances is separated;
    - the residual is the attention output added to itself.

    ``fixed=True`` is the repaired flavour: attention over T within each
    row, and the residual ``normed input + pe + attention output``.

    In training the attention weights and the residual branch are dropped
    at ``dropout``, and the one-utterance collapse is not taken: at B = 1
    the weights of the one element are dropped too, as the JAX package
    does.
    """

    def __init__(self, channels, n_head=8, fixed=False, dropout=0.1):
        super().__init__()
        self.n_head = n_head
        self.fixed = fixed
        self.dropout = dropout
        self.attn_in_norm = nn.LayerNorm(channels)
        # parameter holder only: its forward is not the reference's math
        self.attn = nn.MultiheadAttention(channels, n_head)
        self.norm = nn.LayerNorm(channels)
        self._pe = {}

    def _pos_enc(self, T, C, like):
        key = (T, C, like.device, like.dtype)
        if key not in self._pe:
            self._pe[key] = ops.sinusoidal_pe(T, C, like.dtype, like.device)
        return self._pe[key]

    def forward(self, x, per_utterance=False, training=False,
                generator=None):
        B, C, T = x.shape
        a = self.attn
        out = ops.layer_norm(x.transpose(1, 2), self.attn_in_norm.weight,
                             self.attn_in_norm.bias)
        out = out + self._pos_enc(T, C, out)
        drop = dict(dropout_rate=self.dropout, generator=generator,
                    training=training)
        if self.fixed:  # attention over T: (T, B, C) is (L, N, E)
            q = out.transpose(0, 1)
            attn_out = ops.multi_head_attention(
                q, q, q, a.in_proj_weight, a.in_proj_bias, a.out_proj.weight,
                a.out_proj.bias, self.n_head, **drop).transpose(0, 1)
        elif per_utterance or (B == 1 and not training):
            v = F.linear(out, a.in_proj_weight[2 * C:].to(out.dtype),
                         a.in_proj_bias[2 * C:].to(out.dtype))
            attn_out = F.linear(v, a.out_proj.weight.to(out.dtype),
                                a.out_proj.bias.to(out.dtype))
        else:
            attn_out = ops.multi_head_attention(
                out, out, out, a.in_proj_weight, a.in_proj_bias,
                a.out_proj.weight, a.out_proj.bias, self.n_head, **drop)
        res = (out if self.fixed else attn_out) + ops.dropout(
            attn_out, generator, self.dropout, training)
        res = ops.layer_norm(res, self.norm.weight, self.norm.bias)
        return res.transpose(1, 2)


class GA(nn.Module):
    """Global attention: attention sublayer + FFN, each with a residual
    behind drop-path."""

    def __init__(self, out_chan, fixed_mha=False, drop_path=0.1):
        super().__init__()
        self.attn = MultiHeadAttentionModule(out_chan, 8, fixed=fixed_mha)
        self.mlp = FFN(out_chan, out_chan * 2)
        self.drop_path = drop_path

    def forward(self, x, per_utterance=False, training=False,
                generator=None):
        a = self.attn(x, per_utterance, training, generator)
        x = x + ops.drop_path(a, generator, self.drop_path, training)
        m = self.mlp(x, training, generator)
        return x + ops.drop_path(m, generator, self.drop_path, training)


class LA(nn.Module):
    """Local/global fusion:
    local_emb(x_l) * sigmoid(up(global_act(x_g))) + up(global_emb(x_g)),
    with nearest upsampling. All three embeddings are depthwise when
    inp == oup."""

    def __init__(self, inp, oup, kernel=1):
        super().__init__()
        groups = inp if inp == oup else 1
        self.local_embedding = ConvNorm(inp, oup, kernel, groups=groups,
                                        bias=False)
        self.global_embedding = ConvNorm(inp, oup, kernel, groups=groups,
                                         bias=False)
        self.global_act = ConvNorm(inp, oup, kernel, groups=groups,
                                   bias=False)

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
                generator=None):
        return self.tail(x, *self.pyramid(x), per_utterance, training,
                         generator)

    def pyramid(self, x):
        """The block's first half: (the depth scales, their pooled sum at
        the coarsest length)."""
        output = [self.spp_dw[0](self.proj_1x1(x))]
        for k in range(1, self.depth):
            output.append(self.spp_dw[k](output[-1]))
        coarsest = output[-1].shape[-1]
        global_f = output[-1]
        for fea in output[:-1]:
            global_f = global_f + ops.adaptive_avg_pool1d(fea, coarsest)
        return output, global_f

    def tail(self, residual, output, global_f, per_utterance=False,
             training=False, generator=None):
        """The block's second half: GA, LA fusion, expansion, res_conv."""
        global_f = self.globalatt(global_f, per_utterance, training,
                                  generator)
        x_fused = [la(output[i], global_f)
                   for i, la in enumerate(self.loc_glo_fus)]
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            g = x_fused[i - 1] if i == self.depth - 2 else expanded
            expanded = self.last_layer[i](x_fused[i], g)
        return ops.conv1d(expanded, self.res_conv.weight,
                          self.res_conv.bias) + residual


class Recurrent(nn.Module):
    """One shared UConvBlock applied ``_iter`` times; from the second
    iteration its input is concat_block(mixture + x).

    ``remat`` (False, True or "scales") checkpoints each iteration where
    autograd records the graph: ``torch.utils.checkpoint`` (non-reentrant)
    keeps only the iteration's input and recomputes the whole iteration in
    the backward. "scales", the JAX package's default for training, saves
    its pyramid, GA and fusion outputs there; here it is the same full
    per-iteration checkpointing as True (PERF.md gives the step's memory
    with and without it). Under ``torch.no_grad`` nothing is recorded and
    ``remat`` changes nothing.

    In training every iteration draws its dropout masks from a generator of
    its own, seeded from ``generator`` before the iteration starts, so a
    recomputed iteration draws the same masks."""

    def __init__(self, out_channels=128, in_channels=512, upsampling_depth=4,
                 _iter=4, fixed_mha=False, remat=False):
        super().__init__()
        self.unet = UConvBlock(out_channels, in_channels, upsampling_depth,
                               fixed_mha=fixed_mha)
        self.iter = _iter
        self.remat = remat
        self.concat_block = nn.Sequential(
            nn.Conv1d(out_channels, out_channels, 1, groups=out_channels),
            nn.PReLU())

    def forward(self, x, n_iter=None, per_utterance=False, training=False,
                generator=None):
        """``n_iter`` overrides the iteration count (early exit: the
        weights are shared, so any depth up to the trained one is valid)."""
        it_count = self.iter if n_iter is None else int(n_iter)
        if not 1 <= it_count <= self.iter:
            raise ValueError(
                f"n_iter must be in [1, {self.iter}], got {it_count}")
        if training and generator is None:
            raise ValueError("training needs a torch.Generator")
        remat = bool(self.remat) and torch.is_grad_enabled()
        mixture = x
        for i in range(it_count):
            seed = (int(torch.randint(2 ** 62, (), generator=generator,
                                      device=generator.device))
                    if training else None)
            args = (x, mixture, i > 0, per_utterance, training, seed)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._iteration, *args, use_reentrant=False)
            else:
                x = self._iteration(*args)
        return x

    def _iteration(self, x, mixture, concat, per_utterance, training, seed):
        """One iteration; its dropout masks come from a generator on x's
        device seeded with ``seed``."""
        gen = None
        if training:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        if concat:
            x = self._concat(mixture + x)
        return self.unet(x, per_utterance, training, gen)

    def _concat(self, inp):
        conv, act = self.concat_block
        y = ops.conv1d(inp, conv.weight, conv.bias, groups=conv.groups)
        return ops.prelu(y, act.weight)
