"""TransXNet's 1-D pieces as ``nn.Module``s (counterpart of
``tdanet_tpu/models/transxnet.py``): input-dependent dynamic convs
(IDConv), OSRA attention, the D-Mixer hybrid token mixer, MS-FFN and
LayerScale, the parts the EMCAD-era TDANet variants compose.

Module and parameter names follow the JAX package's parameter tree. The
norms are GroupNorm(1, C, eps 1e-8) unless a module says otherwise (the
D-Mixer's projection norms take torch's default 1e-5). A ``ConvModule``
that is a depthwise 'same' conv in #1's range with a norm (OSRA's ``sr``
K1 conv) runs kernel #1 by the components' rule; the dynamic convs have
per-sample weights and no norm, and stay ``F.conv1d`` with ``B * C``
groups, as the reference computes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tdanet_tpu_torch.models.components import (
    GroupNorm1, conv_then_norm, routes_to_kernel)
from tdanet_tpu_torch.ops import basic as ops


def _act(name, x, prelu=None):
    """The activation ``name`` (a PReLU's slope from ``prelu``)."""
    return ops.activation(name, x, None if prelu is None else prelu.weight)


class ConvModule(nn.Module):
    """conv (+ GroupNorm(1, C, eps 1e-8)) (+ relu, gelu or PReLU). A
    depthwise 'same' conv in #1's range with a norm runs #1."""

    def __init__(self, in_chans, embed_dim, kernel_size, stride=1,
                 padding="auto", groups=1, bias="auto", norm=True,
                 act=None):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2 if padding == "auto" else padding
        bias = (not norm) if bias == "auto" else bias
        self.conv = nn.Conv1d(in_chans, embed_dim, kernel_size, stride,
                              self.padding, groups=groups, bias=bias)
        self.norm = GroupNorm1(embed_dim) if norm else None
        self.act_name = act
        self.act = nn.PReLU() if act == "prelu" else None
        self.on_kernel = norm and routes_to_kernel(self.conv, stride,
                                                   self.padding)

    def forward(self, x):
        if self.norm is not None:
            x = conv_then_norm(x, self.conv, self.norm, self.stride,
                               self.padding, self.on_kernel)
        else:
            x = ops.conv1d_module(x, self.conv, stride=self.stride,
                                  padding=self.padding)
        if self.act_name is None:
            return x
        return _act(self.act_name, x, self.act)


def dynamic_depthwise_conv(x, weight, bias=None, *, stride=1):
    """Per-sample depthwise conv, padding K//2: x (B, C, L), weight
    (B, C, K), bias (B, C) or None -> (B, C, L_out). One ``F.conv1d`` with
    B * C groups on a (1, B * C, L) view, as the reference computes it."""
    B, C, L = x.shape
    K = weight.shape[-1]
    out = F.conv1d(x.reshape(1, B * C, L), weight.reshape(B * C, 1, K),
                   None if bias is None else bias.reshape(B * C),
                   stride=stride, padding=K // 2, groups=B * C)
    return out.reshape(B, C, -1)


class _DynamicBase(nn.Module):
    """The shared part of IDConv and its fixed-length form: the
    projection that predicts each sample's mixture over ``num_groups``
    kernels (and biases), and the per-sample conv."""

    def __init__(self, dim, kernel_size, reduction_ratio, num_groups, stride,
                 act, bias):
        super().__init__()
        assert num_groups > 1
        self.dim, self.K = dim, kernel_size
        self.num_groups, self.stride = num_groups, stride
        red = dim // reduction_ratio
        self.proj = nn.ModuleList([
            ConvModule(dim, red, 1, norm=True,
                       act="prelu" if act is not None else None),
            nn.Conv1d(red, dim * num_groups, 1)])
        self.bias = nn.Parameter(torch.zeros(num_groups, dim)) if bias \
            else None

    def _proj(self, z):
        return ops.conv1d_module(self.proj[0](z), self.proj[1])

    def _mix(self, pooled, x):
        """(weight (B, C, K), bias (B, C) or None) of each sample."""
        B, C, _ = x.shape
        G, K = self.num_groups, self.K
        scale = torch.softmax(self._proj(pooled).reshape(B, G, C, K), dim=1)
        weight = (scale * self.weight[None].to(x.dtype)).sum(dim=1)
        if self.bias is None:
            return weight, None
        bscale = torch.softmax(self._proj(x.mean(dim=-1, keepdim=True))
                               .reshape(B, G, C), dim=1)
        return weight, (bscale * self.bias[None].to(x.dtype)).sum(dim=1)

    @torch.no_grad()
    def init_own_(self, generator):
        ops.trunc_normal_(self.weight, generator)
        if self.bias is not None:
            ops.trunc_normal_(self.bias, generator)


class DynamicConv1d(_DynamicBase):
    """IDConv: each sample's depthwise kernels are a softmax mixture over
    ``num_groups`` weight banks (G, C, K), predicted from the features
    average-pooled to K taps; the bias likewise from their mean."""

    def __init__(self, dim, kernel_size=3, reduction_ratio=4, num_groups=1,
                 stride=1, act="prelu", bias=True):
        super().__init__(dim, kernel_size, reduction_ratio, num_groups,
                         stride, act, bias)
        self.weight = nn.Parameter(torch.zeros(num_groups, dim, kernel_size))

    def forward(self, x):
        weight, bias = self._mix(ops.adaptive_avg_pool1d(x, self.K), x)
        return dynamic_depthwise_conv(x, weight, bias, stride=self.stride)


class FCDyConv1d(_DynamicBase):
    """The fixed-length IDConv: the pooling is a learned Linear L -> K
    (``pool``, sized by the static ``in_feat``, so another length raises)
    and the weight bank one scalar a group (G, 1, 1)."""

    def __init__(self, dim, in_feat, kernel_size=3, reduction_ratio=4,
                 num_groups=1, stride=1, act="prelu", bias=True):
        super().__init__(dim, kernel_size, reduction_ratio, num_groups,
                         stride, act, bias)
        self.in_feat = in_feat
        self.weight = nn.Parameter(torch.zeros(num_groups, 1, 1))
        self.pool = nn.Linear(in_feat, kernel_size, bias=False)

    def forward(self, x):
        if x.shape[-1] != self.in_feat:
            raise ValueError(f"FCDyConv1d was built for {self.in_feat} "
                             f"frames, got {x.shape[-1]}")
        pooled = F.linear(x, self.pool.weight.to(x.dtype))
        weight, bias = self._mix(pooled, x)
        return dynamic_depthwise_conv(x, weight, bias, stride=self.stride)

    @torch.no_grad()
    def init_own_(self, generator):
        super().init_own_(generator)
        bound = 1.0 / math.sqrt(self.in_feat)
        self.pool.weight.uniform_(-bound, bound, generator=generator)


class Attention1D(nn.Module):
    """OSRA, overlapping spatial-reduction attention: keys and values from
    the context reduced by ``sr`` (a K sr+3 stride-sr depthwise
    ConvModule, then a K1 depthwise ConvModule: #1's site) and a local
    depthwise K3 conv residual; an optional learned relative-position
    bias ``rpe`` added to the scores before the softmax, which runs in the
    accumulation dtype."""

    def __init__(self, dim, num_heads=1, qk_scale=None, attn_drop=0.0,
                 sr_ratio=1):
        super().__init__()
        assert dim % num_heads == 0
        self.dim, self.num_heads = dim, num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.sr_ratio = sr_ratio
        self.attn_drop = attn_drop
        self.q = nn.Conv1d(dim, dim, 1)
        self.kv = nn.Conv1d(dim, dim * 2, 1)
        self.local_conv = nn.Conv1d(dim, dim, 3, padding=1, groups=dim)
        if sr_ratio > 1:
            self.sr = nn.ModuleList([
                ConvModule(dim, dim, sr_ratio + 3, stride=sr_ratio,
                           padding=(sr_ratio + 3) // 2, groups=dim,
                           bias=False, norm=True, act="prelu"),
                ConvModule(dim, dim, 1, groups=dim, bias=False, norm=True,
                           act=None)])

    def _attend(self, x, context, training=False, generator=None, rpe=None):
        B, C, L = x.shape
        H = self.num_heads
        hd = C // H
        acc = ops.acc_dtype(x.dtype)
        q = ops.conv1d_module(x, self.q).reshape(B, H, hd, L).transpose(2, 3)
        kv_in = self.sr[1](self.sr[0](context)) if self.sr_ratio > 1 \
            else context
        kv_in = ops.conv1d_module(kv_in, self.local_conv, padding=1) + kv_in
        k, v = ops.conv1d_module(kv_in, self.kv).chunk(2, dim=1)
        S = k.shape[-1]
        k = k.reshape(B, H, hd, S)
        v = v.reshape(B, H, hd, S).transpose(2, 3)
        attn = torch.matmul(q.to(acc), k.to(acc)) * self.scale
        if rpe is not None:
            if rpe.shape[2:] != attn.shape[2:]:
                raise ValueError(f"relative position table {tuple(rpe.shape)}"
                                 f" for scores {tuple(attn.shape)}")
            attn = attn + rpe.to(attn.dtype)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        attn = ops.dropout(attn, generator, self.attn_drop, training)
        out = torch.matmul(attn.to(acc), v.to(acc)).to(x.dtype)
        return out.transpose(2, 3).reshape(B, C, L)

    def forward(self, x, training=False, generator=None, rpe=None):
        return self._attend(x, x, training, generator, rpe)


class CrossAttention1D(Attention1D):
    """CrossOSRA: keys and values from ``context`` (x when None)."""

    def forward(self, x, context=None, training=False, generator=None):
        return self._attend(x, x if context is None else context, training,
                            generator)


class MultiScaleDWConv1D(nn.Module):
    """Parallel biased depthwise convs at kernel scales (1, 3, 5, 7) over
    channel splits (the first split takes the remainder); no norm."""

    def __init__(self, dim, scale=(1, 3, 5, 7)):
        super().__init__()
        self.scale = scale
        n = len(scale)
        self.channels = [dim - dim // n * (n - 1)] + [dim // n] * (n - 1)
        self.proj = nn.ModuleList([
            nn.Conv1d(ch, ch, k, padding=k // 2, groups=ch)
            for ch, k in zip(self.channels, scale)])

    def forward(self, x):
        outs = [ops.conv1d_module(piece, conv, padding=k // 2)
                for piece, conv, k in zip(x.split(self.channels, dim=1),
                                          self.proj, self.scale)]
        return torch.cat(outs, dim=1)


class Mlp1D(nn.Module):
    """MS-FFN: 1x1 -> act -> GN -> multi-scale dwconv residual -> act ->
    GN -> dropout -> 1x1 -> GN -> dropout (GN eps 1e-8)."""

    def __init__(self, in_features, hidden_features=None, out_features=None,
                 act="gelu", drop=0.0):
        super().__init__()
        out_features = out_features or in_features
        hidden = hidden_features or in_features
        self.act_name, self.drop = act, drop
        fc1 = {"0": nn.Conv1d(in_features, hidden, 1, bias=False),
               "2": GroupNorm1(hidden)}
        if act == "prelu":
            fc1["1"] = nn.PReLU()
            self.act = nn.PReLU()
        self.fc1 = nn.ModuleDict(fc1)
        self.dwconv = MultiScaleDWConv1D(hidden)
        self.norm = GroupNorm1(hidden)
        self.fc2 = nn.ModuleDict({
            "0": nn.Conv1d(hidden, out_features, 1, bias=False),
            "1": GroupNorm1(out_features)})

    def forward(self, x, training=False, generator=None):
        fc1, fc2, prelu = self.fc1, self.fc2, self.act_name == "prelu"
        x = _act(self.act_name, ops.conv1d_module(x, fc1["0"]),
                 fc1["1"] if prelu else None)
        x = fc1["2"](x)
        x = self.dwconv(x) + x
        x = self.norm(_act(self.act_name, x, self.act if prelu else None))
        x = ops.dropout(x, generator, self.drop, training)
        x = fc2["1"](ops.conv1d_module(x, fc2["0"]))
        return ops.dropout(x, generator, self.drop, training)


class LayerScale1D(nn.Module):
    """Per-channel scale (weight (dim, 1, 1), initialised at
    ``init_value``) and bias."""

    def __init__(self, dim, init_value=1e-5):
        super().__init__()
        self.init_value = init_value
        self.weight = nn.Parameter(torch.full((dim, 1, 1), init_value))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return x * self.weight.to(x.dtype)[None, :, :, 0] \
            + self.bias.to(x.dtype)[None, :, None]

    @torch.no_grad()
    def init_own_(self, generator):
        self.weight.fill_(self.init_value)
        self.bias.zero_()


class HybridTokenMixer1D(nn.Module):
    """D-Mixer: the channel halves through IDConv and OSRA, concatenated,
    then a squeezed transform-excite projection residual (its norms
    GroupNorm(1, C) at eps 1e-5, each after a GELU, not after a conv: no
    #1 site)."""

    def __init__(self, dim, kernel_size=3, num_groups=2, num_heads=1,
                 sr_ratio=1, reduction_ratio=8):
        super().__init__()
        assert dim % 2 == 0
        self.dim = dim
        self.local_unit = DynamicConv1d(dim // 2, kernel_size,
                                        num_groups=num_groups)
        self.global_unit = Attention1D(dim // 2, num_heads=num_heads,
                                       sr_ratio=sr_ratio)
        inner = max(16, dim // reduction_ratio)
        self.proj = nn.ModuleDict({
            "0": nn.Conv1d(dim, dim, 3, padding=1, groups=dim),
            "2": GroupNorm1(dim, eps=1e-5),
            "3": nn.Conv1d(dim, inner, 1),
            "5": GroupNorm1(inner, eps=1e-5),
            "6": nn.Conv1d(inner, dim, 1),
            "7": GroupNorm1(dim, eps=1e-5)})

    def forward(self, x, training=False, generator=None, rpe=None):
        x1, x2 = x.chunk(2, dim=1)
        y = torch.cat([self.local_unit(x1),
                       self.global_unit(x2, training, generator, rpe)], dim=1)
        p = self.proj
        z = p["2"](ops.gelu(ops.conv1d_module(y, p["0"], padding=1)))
        z = p["5"](ops.gelu(ops.conv1d_module(z, p["3"])))
        return p["7"](ops.conv1d_module(z, p["6"])) + y


class Block1D(nn.Module):
    """TransXNet's block: a depthwise K7 positional conv residual, the
    D-Mixer and the MS-FFN, each behind LayerScale and drop-path."""

    def __init__(self, dim=64, kernel_size=3, sr_ratio=1, num_groups=2,
                 num_heads=1, mlp_ratio=4, act="relu", drop=0.0,
                 drop_path=0.0, layer_scale_init_value=1e-5):
        super().__init__()
        self.pos_embed = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm1 = GroupNorm1(dim)
        self.token_mixer = HybridTokenMixer1D(dim, kernel_size, num_groups,
                                              num_heads, sr_ratio)
        self.norm2 = GroupNorm1(dim)
        self.mlp = Mlp1D(dim, int(dim * mlp_ratio), act=act, drop=drop)
        self.drop_path = drop_path
        if layer_scale_init_value is not None:
            self.layer_scale_1 = LayerScale1D(dim, layer_scale_init_value)
            self.layer_scale_2 = LayerScale1D(dim, layer_scale_init_value)
        else:
            self.layer_scale_1 = self.layer_scale_2 = None

    def forward(self, x, per_utterance=False, training=False, generator=None,
                rpe=None):
        """``per_utterance`` is accepted for the GA interface; nothing here
        mixes the batch's rows."""
        x = x + ops.conv1d_module(x, self.pos_embed, padding=3)
        t = self.token_mixer(self.norm1(x), training, generator, rpe)
        if self.layer_scale_1 is not None:
            t = self.layer_scale_1(t)
        x = x + ops.drop_path(t, generator, self.drop_path, training)
        m = self.mlp(self.norm2(x), training, generator)
        if self.layer_scale_2 is not None:
            m = self.layer_scale_2(m)
        return x + ops.drop_path(m, generator, self.drop_path, training)
