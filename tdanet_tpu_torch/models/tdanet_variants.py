"""The TDANet variant family: paper baselines and research ablations
(counterpart of ``tdanet_tpu/models/tdanet_variants.py``).

All share TDANetBest's masking pipeline (lattice pad -> frame encoder ->
norm -> bottleneck -> shared-weight recurrent block -> PReLU + 1x1 mask
head -> ReLU mask x encoder features -> overlap-add decoder -> trim) with
GroupNorm in place of GlobLN. They differ in the separator block
(:class:`UConvBlockInject`: inject-sum or gate, avg-pool or conv-pool
global branch, the downsampling stride, the MHA flavour, the first
expansion's pair), the recurrence (plain or GRU-gated) and the front end
(framed conv, a multi-kernel bank, or waveform chunks).

A variant's ``forward(wav, per_utterance=False, *, training=False,
generator=None, compute_dtype=None)`` takes what the JAX ``apply`` takes,
and the port's ``per_utterance``. The variants have no early exit and no
progressive stages (the JAX variants have none): ``num_blocks`` is not an
argument, so passing it raises TypeError, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tdanet_tpu_torch.models.base import BaseModel, register_model, \
    warn_unused_kwargs
from tdanet_tpu_torch.models.components import (
    GatedRecurrent, GroupNorm1, Recurrent, UConvBlockInject)
from tdanet_tpu_torch.ops import basic as ops


def _as_batch(wav, dtype):
    """wav (T,), (B, T) or (B, 1, T) -> ((B, T) in ``dtype``, was 1-D)."""
    was_one_d = wav.ndim == 1
    if was_one_d:
        wav = wav[None]
    if wav.ndim == 3:
        wav = wav.squeeze(1)
    return wav.to(dtype), was_one_d


class _StandardTDANet(BaseModel):
    """The family's shared pipeline (lattice pad -> encode -> GroupNorm ->
    bottleneck -> separate -> mask -> decode -> trim); the class
    attributes choose the block and the recurrence."""

    FIXED_MHA = False
    POOL = "avg"
    DOWN_STRIDE = 2
    INJECT = "add"
    EXPAND_PAIR = "prev"
    MHA_KWARGS = None
    GA_USE_ATTN = True
    DROPS = dict(drop_path=0.1, attn_dropout=0.1, ffn_drop=0.1)
    GATED = False

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=4, enc_kernel_size=21, num_sources=2,
                 sample_rate=16000, remat=False, **unused):
        warn_unused_kwargs(type(self).__name__, unused)
        super().__init__(sample_rate=sample_rate)
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.num_blocks = num_blocks
        self.upsampling_depth = upsampling_depth
        self.enc_kernel_size_ms = enc_kernel_size
        self.enc_kernel_size = enc_kernel_size * sample_rate // 1000
        self.enc_num_basis = self.enc_kernel_size // 2 + 1
        self.num_sources = num_sources
        # the stride lattice that arbitrary-length inputs are padded to
        self.lcm = abs(self.enc_kernel_size // 4 * 4 ** upsampling_depth) \
            // math.gcd(self.enc_kernel_size // 4, 4 ** upsampling_depth)
        # the encoder's kernel, stride and padding
        K = self.enc_kernel_size
        self.win = (K, K // 4, K // 2)
        self._make_codec()
        block = UConvBlockInject(
            out_channels, in_channels, upsampling_depth, pool=self.POOL,
            down_stride=self.DOWN_STRIDE, fixed_mha=self.FIXED_MHA,
            inject=self.INJECT, expand_pair=self.EXPAND_PAIR,
            mha_kwargs=self.MHA_KWARGS, ga_use_attn=self.GA_USE_ATTN,
            **self.DROPS)
        if self.GATED:
            self.sm = GatedRecurrent(out_channels, block, num_blocks)
        else:
            self.sm = Recurrent(out_channels, in_channels, upsampling_depth,
                                num_blocks, remat=remat, block=block)

    def _make_codec(self):
        """The encoder, its norm, the bottleneck, the mask head and the
        decoder."""
        (K, S, P), C = self.win, self.enc_num_basis
        self.encoder = nn.Conv1d(1, C, K, stride=S, padding=P, bias=False)
        self.ln = GroupNorm1(C)
        self.bottleneck = nn.Conv1d(C, self.out_channels, 1)
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(self.out_channels, self.num_sources * C, 1))
        self.decoder = nn.ConvTranspose1d(C * self.num_sources,
                                          self.num_sources, K, stride=S,
                                          padding=P, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        K, C = self.win[0], self.enc_num_basis
        ops.xavier_init_(self.encoder.weight, 1, C, K, generator)
        ops.xavier_init_(self.decoder.weight, C * self.num_sources,
                         self.num_sources, K, generator)
        return self

    def _pad(self, wav):
        """The lattice pad: (padded wav, rest)."""
        K, S, _ = self.win
        return ops.pad_signal(wav, K, S)

    def _trim(self, est, rest):
        K, S, _ = self.win
        return est[:, :, K - S: est.shape[-1] - (rest + K - S)]

    def _encode(self, x):
        """(B, T) -> (the separator's input, the features the mask
        multiplies)."""
        _, S, P = self.win
        s = ops.conv1d(x[:, None, :], self.encoder.weight, stride=S,
                       padding=P)
        x = self.ln(s)
        return ops.conv1d(x, self.bottleneck.weight, self.bottleneck.bias), s

    def _mask(self, x, s, channels):
        """Mask head -> ReLU mask x ``s`` -> (B, n_src * channels, T)."""
        act, head = self.mask_net
        x = ops.conv1d(ops.prelu(x, act.weight), head.weight, head.bias)
        B = x.shape[0]
        x = F.relu(x.reshape(B, self.num_sources, channels, -1))
        return (x * s[:, None]).reshape(B, self.num_sources * channels, -1)

    def forward(self, wav, per_utterance=False, *, training=False,
                generator=None, compute_dtype=None, dp_group=None):
        """wav (T,), (B, T) or (B, 1, T) -> estimates (n_src, T) or
        (B, n_src, T), in ``compute_dtype`` or else the parameters' dtype.
        ``per_utterance=True`` separates every row as if it were alone (the
        batch-axis attention's collapse); ``training=True`` turns on
        dropout and drop-path, with masks from ``generator``."""
        wav, was_one_d = _as_batch(wav, compute_dtype
                                   or self.decoder.weight.dtype)
        x, rest = self._pad(wav)
        x, s = self._encode(x)
        x = self.sm(x, per_utterance=per_utterance, training=training,
                    generator=generator, dp_group=dp_group)
        _, S, P = self.win
        est = ops.conv_transpose1d(self._mask(x, s, s.shape[1]),
                                   self.decoder.weight, stride=S, padding=P)
        est = self._trim(est, rest)
        return est[0] if was_one_d else est

    def get_model_args(self):
        return {"out_channels": self.out_channels,
                "in_channels": self.in_channels,
                "num_blocks": self.num_blocks,
                "upsampling_depth": self.upsampling_depth,
                "enc_kernel_size": self.enc_kernel_size_ms,
                "num_sources": self.num_sources,
                "sample_rate": self._sample_rate}


@register_model
class TDANetYang(_StandardTDANet):
    """The reference's default model: the paper topology with GroupNorm,
    avg-pool and inject-sum, and the unfixed (batch-axis) MHA. Accepts the
    unused feat_len argument."""

    def __init__(self, *args, feat_len=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.feat_len = feat_len


@register_model
class TDANetOrigin(_StandardTDANet):
    """The ICLR-paper baseline."""


@register_model
class TDANetOld(_StandardTDANet):
    """The older paper baseline: batch_first=True MHA (attention over
    frames) with the self-added residual, a multiplicative sigmoid
    injection gate, and the first expansion paired with the coarsest
    scale."""

    INJECT = "gate"
    EXPAND_PAIR = "next"
    MHA_KWARGS = dict(batch_first=True, self_residual=True)


@register_model
class TDANet(_StandardTDANet):
    """The modified research version: the global branch downsamples with
    strided separable "conv-pool" convs in place of the adaptive average
    pool, applied in reverse scale order."""

    POOL = "conv"

    def __init__(self, *args, feat_len=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.feat_len = feat_len


@register_model
class TDANetNoDrop(_StandardTDANet):
    """Every dropout and drop-path at 0: training equals inference."""

    DROPS = dict(drop_path=0.0, attn_dropout=0.0, ffn_drop=0.0)


@register_model
class TDANetULayerNum(_StandardTDANet):
    """The depth ablation: downsampling stride 16 (kernel 33) and an
    MLP-only global branch (no MHA)."""

    DOWN_STRIDE = 16
    GA_USE_ATTN = False


@register_model
class TDANetGateVariant(_StandardTDANet):
    """GRU-style reset and update convolution gates around the shared
    block (:class:`GatedRecurrent`)."""

    GATED = True


@register_model
class TDANetChunk(BaseModel):
    """The learned frame encoder replaced by a waveform reshape into
    ``n_chunk`` channels; the masked chunks are reshaped straight back to
    waveforms (no transposed-conv decode). There is no lattice: T must be
    a multiple of ``n_chunk`` (the caller's duty, as in the JAX package).
    A 1-D input gives (1, n_src, T), as the JAX class does."""

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=4, n_chunk=32, num_sources=2,
                 sample_rate=16000, **unused):
        warn_unused_kwargs(type(self).__name__, unused)
        super().__init__(sample_rate=sample_rate)
        self.out_channels = out_channels
        self.in_channels = in_channels
        self.num_blocks = num_blocks
        self.upsampling_depth = upsampling_depth
        self.n_chunk = n_chunk
        self.num_sources = num_sources
        self.ln = GroupNorm1(n_chunk)
        self.bottleneck = nn.Conv1d(n_chunk, out_channels, 1)
        block = UConvBlockInject(out_channels, in_channels,
                                 upsampling_depth)
        self.sm = Recurrent(out_channels, in_channels, upsampling_depth,
                            num_blocks, block=block)
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(out_channels, num_sources * n_chunk, 1))

    def forward(self, wav, per_utterance=False, *, training=False,
                generator=None, compute_dtype=None, dp_group=None):
        """wav (T,), (B, T) or (B, 1, T), T a multiple of ``n_chunk`` ->
        (B, n_src, T)."""
        wav, _ = _as_batch(wav, compute_dtype or self.bottleneck.weight.dtype)
        B = wav.shape[0]
        s = wav.reshape(B, self.n_chunk, -1)
        x = self.ln(s)
        x = ops.conv1d(x, self.bottleneck.weight, self.bottleneck.bias)
        x = self.sm(x, per_utterance=per_utterance, training=training,
                    generator=generator, dp_group=dp_group)
        act, head = self.mask_net
        x = ops.conv1d(ops.prelu(x, act.weight), head.weight, head.bias)
        x = F.relu(x.reshape(B, self.num_sources, self.n_chunk, -1))
        return (x * s[:, None]).reshape(B, self.num_sources, -1)

    def get_model_args(self):
        return {"out_channels": self.out_channels,
                "in_channels": self.in_channels,
                "num_blocks": self.num_blocks,
                "upsampling_depth": self.upsampling_depth,
                "n_chunk": self.n_chunk,
                "num_sources": self.num_sources,
                "sample_rate": self._sample_rate}


class _ConvBank(nn.Module):
    """TDANetMultRes's encoder: ``conv_list`` of Conv1d banks."""

    def __init__(self, convs):
        super().__init__()
        self.conv_list = nn.ModuleList(convs)


@register_model
class TDANetMultRes(_StandardTDANet):
    """A multi-resolution front end: ``kernels`` parallel Conv1d banks of
    kernel k * enc_kernel_size (the shared stride enc_kernel_size // 4),
    trimmed to the shortest and concatenated over channels to
    out_channels; no bottleneck; the mask head and the decoder sized on
    out_channels; the fixed MHA (attention over T, the true residual).
    ``out_channels`` must be a multiple of ``kernels``."""

    FIXED_MHA = True

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=4, enc_kernel_size=21, num_sources=2,
                 sample_rate=16000, feat_len=None, kernels=3, **unused):
        warn_unused_kwargs(type(self).__name__, unused)
        assert out_channels % kernels == 0
        self.kernels = kernels
        super().__init__(out_channels, in_channels, num_blocks,
                         upsampling_depth, enc_kernel_size, num_sources,
                         sample_rate)
        self.feat_len = feat_len

    def _make_codec(self):
        (K, S, _), B = self.win, self.out_channels
        self.encoder = _ConvBank(
            nn.Conv1d(1, B // self.kernels, k * K, stride=S,
                      padding=k * K // 2, bias=False)
            for k in range(1, self.kernels + 1))
        self.ln = GroupNorm1(B)
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(B, self.num_sources * B, 1))
        self.decoder = nn.ConvTranspose1d(B * self.num_sources,
                                          self.num_sources, K, stride=S,
                                          padding=K // 2, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        BaseModel.reset_parameters(self, generator)
        K, B = self.win[0], self.out_channels
        for k, conv in enumerate(self.encoder.conv_list, start=1):
            ops.xavier_init_(conv.weight, 1, B // self.kernels, k * K,
                             generator)
        ops.xavier_init_(self.decoder.weight, B * self.num_sources,
                         self.num_sources, K, generator)
        return self

    def _encode(self, x):
        S = self.win[1]
        embs = [ops.conv1d(x[:, None, :], conv.weight, stride=S,
                           padding=conv.padding[0])
                for conv in self.encoder.conv_list]
        L = min(e.shape[-1] for e in embs)
        s = torch.cat([e[..., :L] for e in embs], dim=1)
        return self.ln(s), s

    def get_model_args(self):
        args = super().get_model_args()
        args["kernels"] = self.kernels
        return args


@register_model
class TDANetAttn(_StandardTDANet):
    """``stride`` reparameterises the encoder and the decoder (kernel
    4 * stride, padding 2 * stride); ``fixed_len`` centre-pads the input to
    (fixed_len - 1) * stride samples in place of the lattice pad, and the
    output is trimmed back by the same amount on each side."""

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=4, enc_kernel_size=21, num_sources=2,
                 sample_rate=16000, feat_len=None, fixed_len=None,
                 stride=None, **unused):
        warn_unused_kwargs(type(self).__name__, unused)
        self.stride = stride
        super().__init__(out_channels, in_channels, num_blocks,
                         upsampling_depth, enc_kernel_size, num_sources,
                         sample_rate)
        self.feat_len = feat_len
        self.fixed_len = fixed_len

    def _make_codec(self):
        if self.stride is not None:
            self.win = (self.stride * 4, self.stride, self.stride * 2)
        super()._make_codec()

    def _pad(self, wav):
        if self.fixed_len is None:
            return super()._pad(wav)
        target = (self.fixed_len - 1) * self.win[1]
        T = wav.shape[-1]
        if T > target:
            raise ValueError(f"input of {T} samples is longer than "
                             f"fixed_len's {target}")
        rest = (target - T) // 2
        return F.pad(wav, (rest, target - T - rest)), rest

    def _trim(self, est, rest):
        if self.fixed_len is None:
            return super()._trim(est, rest)
        return est[:, :, rest:est.shape[-1] - rest]


@register_model
class TDANetV2(_StandardTDANet):
    """The TDANetBlock restructure: inject-sum with the first expansion
    paired with the coarsest scale and the unfixed MHA (the working
    equivalent of a reference class that cannot be instantiated)."""

    EXPAND_PAIR = "next"
    MHA_KWARGS = dict(batch_first=False, self_residual=True)
