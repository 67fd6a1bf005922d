"""TDANetBest, the flagship separator (counterpart of
``tdanet_tpu/models/tdanet_best.py``).

Lattice pad -> Conv1d frame encoder -> GlobLN -> 1x1 bottleneck ->
shared-weight recurrent UConvBlock -> PReLU + 1x1 mask head -> ReLU mask x
encoder features -> ConvTranspose1d overlap-add decoder -> trim.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tdanet_tpu_torch.models.base import BaseModel, register_model, \
    warn_unused_kwargs
from tdanet_tpu_torch.models.components import GlobLN, Recurrent
from tdanet_tpu_torch.ops import basic as ops


@register_model
class TDANetBest(BaseModel):
    def __init__(self, out_channels=128, in_channels=512, num_blocks=16,
                 upsampling_depth=4, enc_kernel_size=21, num_sources=2,
                 sample_rate=16000, fixed_mha=False, remat=False,
                 **unused):
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
        K, C = self.enc_kernel_size, self.enc_num_basis
        self.encoder = nn.Conv1d(1, C, K, stride=K // 4, padding=K // 2,
                                 bias=False)
        self.ln = GlobLN(C)
        self.bottleneck = nn.Conv1d(C, out_channels, 1)
        self.sm = Recurrent(out_channels, in_channels, upsampling_depth,
                            num_blocks, fixed_mha=fixed_mha, remat=remat)
        self.mask_net = nn.Sequential(
            nn.PReLU(), nn.Conv1d(out_channels, num_sources * C, 1))
        self.decoder = nn.ConvTranspose1d(C * num_sources, num_sources, K,
                                          stride=K // 4, padding=K // 2,
                                          bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        K, C = self.enc_kernel_size, self.enc_num_basis
        ops.xavier_init_(self.encoder.weight, 1, C, K, generator)
        ops.xavier_init_(self.decoder.weight, C * self.num_sources,
                         self.num_sources, K, generator)
        return self

    def _front(self, wav):
        """Lattice pad -> framed conv encoder -> GlobLN -> bottleneck.
        Returns (bottleneck feats, encoder feats, rest)."""
        K = self.enc_kernel_size
        x, rest = ops.pad_signal(wav, K, K // 4)
        s = ops.conv1d(x[:, None, :], self.encoder.weight, stride=K // 4,
                       padding=K // 2)
        x = self.ln(s)
        x = ops.conv1d(x, self.bottleneck.weight, self.bottleneck.bias)
        return x, s, rest

    def _back(self, x, s, rest):
        """Mask head -> mask x encoder feats -> overlap-add -> trim."""
        K = self.enc_kernel_size
        S = K // 4
        act, head = self.mask_net
        x = ops.conv1d(ops.prelu(x, act.weight), head.weight, head.bias)
        B = x.shape[0]
        x = F.relu(x.reshape(B, self.num_sources, self.enc_num_basis, -1))
        x = x * s[:, None]
        est = ops.conv_transpose1d(
            x.reshape(B, self.num_sources * self.enc_num_basis, -1),
            self.decoder.weight, stride=S, padding=K // 2)
        return est[:, :, K - S: est.shape[-1] - (rest + K - S)]

    def forward(self, wav, num_blocks=None, per_utterance=False, *,
                training=False, generator=None, compute_dtype=None):
        """wav (T,), (B, T) or (B, 1, T) -> estimates (n_src, T) or
        (B, n_src, T), in ``compute_dtype`` or else the parameters' dtype.

        ``num_blocks`` overrides the recurrence depth (early exit).
        ``per_utterance=True`` separates every row as if it were alone (see
        MultiHeadAttentionModule); the default keeps the reference's
        batch-axis attention across rows. ``training=True`` turns on
        dropout and drop-path, with masks from ``generator``.
        ``compute_dtype`` (e.g. torch.bfloat16) is the activations' dtype,
        as the JAX package's: the wav is cast to it, every op casts its
        parameters to it, the parameters stay in their own dtype (fp32
        master weights, whose gradients stay fp32) and statistics
        accumulate in at least fp32; the depthwise ConvNorm kernels read
        fp32 parameters as they are."""
        was_one_d = wav.ndim == 1
        if was_one_d:
            wav = wav[None]
        if wav.ndim == 3:
            wav = wav.squeeze(1)
        wav = wav.to(compute_dtype or self.encoder.weight.dtype)
        x, s, rest = self._front(wav)
        x = self.sm(x, n_iter=num_blocks, per_utterance=per_utterance,
                    training=training, generator=generator)
        est = self._back(x, s, rest)
        return est[0] if was_one_d else est

    def pad_rest(self, T: int) -> int:
        """The ``rest`` that ``ops.pad_signal`` gives a length-T input,
        which stage 2 needs to trim its output."""
        K = self.enc_kernel_size
        return K - (K // 4 + T % K) % K

    @torch.inference_mode()
    def forward_stage1(self, wav, depth, per_utterance=False,
                       compute_dtype=None):
        """Progressive separation, stage 1 (inference only): the
        depth-``depth`` forward and the state to continue it. Returns
        ``(est, state)``: ``est`` equals ``forward(wav, num_blocks=depth,
        compute_dtype=compute_dtype)``; ``state`` holds the bottleneck
        mixture features, the recurrence's carry, the encoder features,
        ``delta`` (each example's relative change in the last iteration,
        the escalation proxy), all with the batch first and in the
        activations' dtype, and the ``depth`` reached. Stage 2 continues
        in the state's dtype."""
        if wav.ndim == 3:
            wav = wav.squeeze(1)
        wav = wav.to(compute_dtype or self.encoder.weight.dtype)
        feats, s, rest = self._front(wav)
        x, delta = self.sm.forward_with_state(feats, n_iter=depth,
                                              per_utterance=per_utterance)
        return self._back(x, s, rest), {"mixture": feats, "carry": x,
                                        "enc": s, "delta": delta,
                                        "depth": int(depth)}

    @torch.inference_mode()
    def forward_stage2(self, state, n_more, rest, per_utterance=False):
        """Progressive separation, stage 2: the exact continuation of
        stage 1's carry by ``n_more`` iterations; the estimate equals the
        forward at depth ``state["depth"] + n_more``. ``rest`` is
        ``pad_rest(T)`` of the input length."""
        x = self.sm.continue_forward(state["mixture"], state["carry"],
                                     n_more, state["depth"],
                                     per_utterance=per_utterance)
        return self._back(x, state["enc"], rest)

    def get_model_args(self):
        return {
            "out_channels": self.out_channels,
            "in_channels": self.in_channels,
            "num_blocks": self.num_blocks,
            "upsampling_depth": self.upsampling_depth,
            "enc_kernel_size": self.enc_kernel_size_ms,
            "num_sources": self.num_sources,
            "sample_rate": self._sample_rate,
        }
