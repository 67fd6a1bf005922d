"""SDR-family losses (counterpart of ``tdanet_tpu/losses/sdr.py``).

Pure functions over (B, n_src, T) tensors. The statistics accumulate in at
least float32, as the JAX package's do: bf16 and fp32 inputs are cast to
float32, float64 stays float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdanet_tpu_torch.ops.basic import acc_dtype

EPS = 1e-8


def _acc(x):
    return x.to(acc_dtype(x.dtype))


def _zero_mean(ests, targets, dim):
    return (ests - ests.mean(dim=dim, keepdim=True),
            targets - targets.mean(dim=dim, keepdim=True))


def pairwise_neg_sdr(ests, targets, *, sdr_type="sisdr", zero_mean=True,
                     take_log=True, eps=EPS):
    """(B, n_src, T) x2 -> (B, n_src_est, n_src_tgt) negative SDR matrix."""
    assert ests.ndim == 3 and ests.shape == targets.shape
    ests, targets = _acc(ests), _acc(targets)
    if zero_mean:
        ests, targets = _zero_mean(ests, targets, 2)
    tgt_sq = targets.square().sum(dim=2)                       # (B, j)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = torch.einsum("bit,bjt->bij", ests, targets)
        tgt_energy = tgt_sq + eps
        coeff = dot / tgt_energy[:, None, :]
        proj_energy = coeff.square() * tgt_energy[:, None, :]
    else:  # snr: the "projection" is the target itself
        proj_energy = tgt_sq[:, None, :].expand(
            ests.shape[0], ests.shape[1], targets.shape[1])
    est_energy = ests.square().sum(dim=2)                      # (B, i)
    if sdr_type in ("sdsdr", "snr"):
        cross = torch.einsum("bit,bjt->bij", ests, targets)
        noise_energy = (est_energy[:, :, None] - 2 * cross
                        + tgt_sq[:, None, :])
    else:
        # ||est - proj||^2 = ||est||^2 - ||proj||^2
        noise_energy = est_energy[:, :, None] - proj_energy
    ratio = proj_energy / (noise_energy + eps)
    if take_log:
        return -10.0 * torch.log10(ratio + eps)
    return -ratio


def _scaled(ests, targets, sdr_type, zero_mean, eps, dim):
    ests, targets = _acc(ests), _acc(targets)
    if zero_mean:
        ests, targets = _zero_mean(ests, targets, dim)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (ests * targets).sum(dim=dim, keepdim=True)
        tgt_energy = targets.square().sum(dim=dim, keepdim=True) + eps
        scaled = dot * targets / tgt_energy
    else:
        scaled = targets
    e_noise = ests - (targets if sdr_type in ("sdsdr", "snr") else scaled)
    return (scaled.square().sum(dim=dim)
            / (e_noise.square().sum(dim=dim) + eps))


def singlesrc_neg_sdr(ests, targets, *, sdr_type="sisdr", zero_mean=True,
                      take_log=True, eps=EPS):
    """(B, T) x2 -> (B,)."""
    assert ests.ndim == 2
    ratio = _scaled(ests, targets, sdr_type, zero_mean, eps, 1)
    if take_log:
        return -10.0 * torch.log10(ratio + eps)
    return -ratio


def multisrc_neg_sdr(ests, targets, *, sdr_type="sisdr", zero_mean=True,
                     take_log=True, eps=EPS):
    """(B, n_src, T) x2 -> (B,), sources in the given order."""
    assert ests.ndim == 3
    ratio = _scaled(ests, targets, sdr_type, zero_mean, eps, 2)
    if take_log:
        ratio = 10.0 * torch.log10(ratio + eps)
    return -ratio.mean(dim=-1)


def freq_mae_wavl1(ests, targets, *, win=2048, stride=512):
    """STFT-L1 (real and imaginary parts, a periodic Hann window, torch.stft
    center=True framing) plus waveform-L1, per utterance."""
    B, nsrc, T = ests.shape
    acc = acc_dtype(ests.dtype)
    window = torch.from_numpy(np.hanning(win + 1)[:-1]).to(
        dtype=acc, device=ests.device)

    def stft(x):
        x = F.pad(x.reshape(-1, 1, T), (win // 2, win // 2),
                  mode="reflect")[:, 0]
        frames = x.unfold(-1, win, stride) * window
        return torch.fft.rfft(frames, dim=-1).transpose(1, 2)

    es, ts = stft(ests.to(acc)), stft(targets.to(acc))
    freq_l1 = ((es.real - ts.real).abs().mean(dim=(1, 2))
               + (es.imag - ts.imag).abs().mean(dim=(1, 2)))
    freq_l1 = freq_l1.reshape(B, nsrc).mean(dim=-1)
    wave_l1 = (ests - targets).abs().mean(dim=-1).reshape(B, nsrc) \
        .mean(dim=-1)
    return freq_l1 + wave_l1


# class-style factories with the reference's names: calling one returns the
# configured function
def PairwiseNegSDR(sdr_type, zero_mean=True, take_log=True, EPS=1e-8):
    return functools.partial(pairwise_neg_sdr, sdr_type=sdr_type,
                             zero_mean=zero_mean, take_log=take_log, eps=EPS)


def SingleSrcNegSDR(sdr_type, zero_mean=True, take_log=True,
                    reduction="none", EPS=1e-8):
    if reduction == "sum":
        raise NotImplementedError("reduction='sum'")
    fn = functools.partial(singlesrc_neg_sdr, sdr_type=sdr_type,
                           zero_mean=zero_mean, take_log=take_log, eps=EPS)
    if reduction == "mean":
        return lambda e, t, **kw: fn(e, t, **kw).mean()
    return fn


def MultiSrcNegSDR(sdr_type, zero_mean=True, take_log=True, EPS=1e-8):
    return functools.partial(multisrc_neg_sdr, sdr_type=sdr_type,
                             zero_mean=zero_mean, take_log=take_log, eps=EPS)


freq_mae_wavl1loss = freq_mae_wavl1

pairwise_neg_sisdr = functools.partial(pairwise_neg_sdr, sdr_type="sisdr")
pairwise_neg_sdsdr = functools.partial(pairwise_neg_sdr, sdr_type="sdsdr")
pairwise_neg_snr = functools.partial(pairwise_neg_sdr, sdr_type="snr")
singlesrc_neg_sisdr = functools.partial(singlesrc_neg_sdr, sdr_type="sisdr")
singlesrc_neg_sdsdr = functools.partial(singlesrc_neg_sdr, sdr_type="sdsdr")
singlesrc_neg_snr = functools.partial(singlesrc_neg_sdr, sdr_type="snr")
multisrc_neg_sisdr = functools.partial(multisrc_neg_sdr, sdr_type="sisdr")
multisrc_neg_sdsdr = functools.partial(multisrc_neg_sdr, sdr_type="sdsdr")
multisrc_neg_snr = functools.partial(multisrc_neg_sdr, sdr_type="snr")
