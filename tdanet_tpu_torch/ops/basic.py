"""Core 1-D ops of the TDANet family in PyTorch, with the JAX package's
numerics (``tdanet_tpu/ops/basic.py``).

Tensors flow in the (B, C, T) layout and parameters keep torch's own
layouts (conv weight (O, I/g, K), transposed-conv weight (I, O/g, K)), so
weights cross from the JAX package as a pure copy. Where the JAX package
re-derived a torch semantic by hand (nearest-index floor, adaptive-pool
bins, GlobLN statistics, batch-axis attention), the port keeps its form so
the two agree in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn import init as nn_init


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype for statistics: at least float32, never below the
    input's precision (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# Initializers: the distributions of the JAX package's init helpers, drawn
# from an explicit generator (torch and JAX give different numbers from one
# seed; only the distributions match).
# ---------------------------------------------------------------------------


@torch.no_grad()
def conv1d_init_(conv, generator: torch.Generator):
    """torch-default Conv1d init: weight and bias from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(conv.in_channels // conv.groups
                            * conv.kernel_size[0])
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_init_(weight: torch.Tensor, in_channels: int, out_channels: int,
                 kernel: int, generator: torch.Generator):
    """xavier_uniform_ over (in + out) * kernel, as the encoder and the
    overlap-add decoder use."""
    bound = math.sqrt(6.0 / ((in_channels + out_channels) * kernel))
    weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def trunc_normal_(weight: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02):
    """A normal truncated at two standard deviations, times ``std`` (the
    Swin linears, bias tables and position embeddings)."""
    nn_init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


@torch.no_grad()
def mha_init_(attn, generator: torch.Generator):
    """nn.MultiheadAttention parameters: xavier in_proj, zero biases,
    U(+-1/sqrt(E)) out_proj."""
    E = attn.embed_dim
    xav = math.sqrt(6.0 / (E + 3 * E))
    attn.in_proj_weight.uniform_(-xav, xav, generator=generator)
    attn.in_proj_bias.zero_()
    out_b = 1.0 / math.sqrt(E)
    attn.out_proj.weight.uniform_(-out_b, out_b, generator=generator)
    attn.out_proj.bias.zero_()


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def conv1d(x, weight, bias=None, *, stride=1, padding=0, dilation=1,
           groups=1):
    """torch Conv1d on (B, C, T); weight (O, I/g, K)."""
    return F.conv1d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def conv1d_module(x, conv, **kw):
    """:func:`conv1d` with a Conv1d module's weight, bias and groups
    (stride and padding as given, 0-padded stride 1 by default)."""
    return conv1d(x, conv.weight, conv.bias, groups=conv.groups, **kw)


def conv_transpose1d(x, weight, bias=None, *, stride=1, padding=0, groups=1):
    """torch ConvTranspose1d; weight (I, O/g, K) is already torch's layout."""
    return F.conv_transpose1d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype),
                              stride=stride, padding=padding, groups=groups)


# ---------------------------------------------------------------------------
# Activations and norms
# ---------------------------------------------------------------------------


def prelu(x, weight):
    """nn.PReLU: one shared slope, or one per channel on axis 1."""
    a = weight.to(x.dtype)
    if a.shape[0] == 1:
        a = a[0]
    else:
        a = a.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, a * x)


def glob_ln(x, gamma, beta, *, eps=1e-8):
    """Global LayerNorm over all non-batch dims, then a per-channel affine.

    One-pass statistics in at least float32 (E[x], E[x^2], var clamped at
    0), as the JAX package computes them; eps sits inside the rsqrt."""
    dims = tuple(range(1, x.ndim))
    xf = x.to(acc_dtype(x.dtype))
    mean = xf.mean(dim=dims, keepdim=True)
    sq = xf.square().mean(dim=dims, keepdim=True)
    var = torch.clamp(sq - mean.square(), min=0.0)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    normed = (x - mean.to(x.dtype)) * scale
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return gamma.to(x.dtype).reshape(shape) * normed \
        + beta.to(x.dtype).reshape(shape)


def group_norm1(x, weight, bias, *, eps=1e-8):
    """nn.GroupNorm(1, C, eps) on (B, C, ...): :func:`glob_ln`'s one-pass
    statistics in the accumulation dtype, with the affine named weight and
    bias."""
    return glob_ln(x, weight, bias, eps=eps)


def layer_norm(x, weight, bias, *, eps=1e-5):
    """nn.LayerNorm over the last dim."""
    return F.layer_norm(x, x.shape[-1:], weight.to(x.dtype),
                        bias.to(x.dtype), eps)


def gelu(x):
    """The exact (erf) GELU."""
    return F.gelu(x)


def activation(name, x, prelu_weight=None):
    """An activation by its config name: relu, relu6, exact gelu, hard
    swish, leaky relu (slope 0.2), or PReLU with ``prelu_weight``."""
    name = name.lower()
    if name == "prelu":
        return prelu(x, prelu_weight)
    if name == "relu":
        return F.relu(x)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "gelu":
        return gelu(x)
    if name == "hswish":
        return F.hardswish(x)
    if name == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# Training-time noise. The draws come from an explicit generator (on any
# device) and are moved to x's device: the same generator gives the same
# mask on the CPU and on the card.
# ---------------------------------------------------------------------------


def _uniform(shape, like, generator: torch.Generator):
    if generator is None:
        raise ValueError("training-time dropout and drop-path need a "
                         "torch.Generator")
    return torch.rand(shape, generator=generator, dtype=acc_dtype(like.dtype),
                      device=generator.device).to(like.device)


def dropout(x, generator: torch.Generator, rate: float, training: bool):
    """Zero each element with probability ``rate`` and scale the kept ones
    by 1 / (1 - rate); the identity at rate 0 or when not training."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = _uniform(x.shape, x, generator) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x, generator: torch.Generator, drop_prob: float,
              training: bool):
    """Stochastic depth: drop whole samples (axis 0) with probability
    ``drop_prob`` and scale the kept ones by 1 / (1 - drop_prob)."""
    if drop_prob == 0.0 or not training:
        return x
    keep = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.floor(keep + _uniform(shape, x, generator)).to(x.dtype)
    return x / keep * mask


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def adaptive_avg_pool1d(x, out_size: int):
    """torch's adaptive average pool: bin i averages
    x[floor(i*L/out) : ceil((i+1)*L/out)]."""
    if x.shape[-1] == out_size:
        return x
    return F.adaptive_avg_pool1d(x, out_size)


def nearest_idx(L: int, out_size: int) -> np.ndarray:
    """The source row of each output row of a nearest resize from L rows:
    floor(i * (L / out)) with the product in float32, as torch's fp32
    kernel and the JAX package compute it (at L=14 -> 110 index 55 maps to
    7, not the exact 6)."""
    idx = np.floor(np.arange(out_size, dtype=np.float32)
                   * np.float32(L / out_size))
    return np.minimum(idx.astype(np.int64), L - 1)


def interpolate_nearest(x, out_size: int):
    """F.interpolate(mode='nearest') on the last axis, reading the source
    rows of :func:`nearest_idx`. For fp32 and bf16 that is F.interpolate
    itself (its float32 index equals nearest_idx for any length below
    2^12); for float64 F.interpolate takes the index in double (at
    80 -> 634 it reads row 40 where fp32 reads 39), so float64 gathers the
    rows of nearest_idx."""
    L = x.shape[-1]
    if L == out_size:
        return x
    if x.dtype != torch.float64:
        return F.interpolate(x, size=out_size, mode="nearest")
    idx = torch.from_numpy(nearest_idx(L, out_size)).to(x.device)
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], out_size))


# ---------------------------------------------------------------------------
# Lattice padding
# ---------------------------------------------------------------------------


def pad_signal(x, window: int, stride: int):
    """Pad (B, T) so that (stride + T) % window == 0, then pad both ends
    with (window - stride) zeros. Returns (padded, rest)."""
    T = x.shape[-1]
    rest = window - (stride + T % window) % window
    aux = window - stride
    return F.pad(x, (aux, rest + aux)), rest


# ---------------------------------------------------------------------------
# Positional encoding and multi-head attention
# ---------------------------------------------------------------------------


def sinusoidal_pe(length: int, channels: int, dtype=torch.float32,
                  device=None):
    """Sinusoidal positional table (length, channels), always computed in
    float32 by the same numpy code as the JAX package, so the two are
    bit-equal."""
    position = np.arange(length)[:, None].astype(np.float32)
    div_term = np.exp(np.arange(0, channels, 2).astype(np.float32)
                      * np.float32(-(math.log(10000.0) / channels)))
    pe = np.zeros((length, channels), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.tensor(pe, dtype=dtype, device=device)


def multi_head_attention(q, k, v, in_proj_weight, in_proj_bias,
                         out_proj_weight, out_proj_bias, num_heads: int, *,
                         dropout_rate=0.0, generator=None, training=False):
    """torch multi_head_attention_forward numerics on (L, N, E) inputs.
    Returns (L, N, E); q is scaled by 1/sqrt(head_dim). In training the
    attention weights are dropped at ``dropout_rate`` with masks drawn from
    ``generator``."""
    L, N, E = q.shape
    S = k.shape[0]
    hd = E // num_heads
    w = in_proj_weight.to(q.dtype)
    b = in_proj_bias.to(q.dtype)
    qp = F.linear(q, w[:E], b[:E])
    kp = F.linear(k, w[E:2 * E], b[E:2 * E])
    vp = F.linear(v, w[2 * E:], b[2 * E:])

    def split_heads(t, length):
        return t.reshape(length, N * num_heads, hd).transpose(0, 1)

    qh = split_heads(qp, L) * (1.0 / math.sqrt(hd))
    kh = split_heads(kp, S)
    vh = split_heads(vp, S)
    acc = acc_dtype(q.dtype)
    scores = torch.bmm(qh.to(acc), kh.to(acc).transpose(1, 2))
    attn = dropout(torch.softmax(scores, dim=-1), generator, dropout_rate,
                   training)
    ctx = torch.bmm(attn, vh.to(acc)).to(q.dtype)
    ctx = ctx.transpose(0, 1).reshape(L, N, E)
    return F.linear(ctx, out_proj_weight.to(q.dtype),
                    out_proj_bias.to(q.dtype))
