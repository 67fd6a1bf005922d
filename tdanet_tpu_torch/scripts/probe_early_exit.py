"""Early exit / variable-depth inference study (counterpart of
``scripts/probe_early_exit.py``).

TDANetBest applies one shared-weight UConvBlock ``num_blocks`` times, so
any depth up to the trained one is a valid program over the same
weights. For each depth d in (16, 12, 8, 6, 4, 2) this prints the
SI-SNRi on a synthetic test set and the realtime factor of a batched
forward, as one JSON line ``{"depth", "sisnri_db", "rtfx"}``.

The test set (:func:`make_tt`) is the JAX probe's, kept so that the table
compares with the JAX package's: the test split's seeds ``2 * 10**6 + i``
and fixed 3 s, but bands (100, 300) and (700, 1500) Hz and no length
draw first, so it is *not* the generator's ``tt`` split
(``make_convergence_data``: bands (100, 280) and (700, 1400), a length
drawn before the voices).

RTFx is ``batch * 3 s`` over the host's wall clock around ``--iters``
eager batched forwards, synchronised with the card at both ends; the
eager forward launches every kernel from the host, so at small batches
this clock may be bound by the host, not the card.

Usage: python -m tdanet_tpu_torch.scripts.probe_early_exit
         [--ckpt PATH] [--n 100] [--batch 25] [--iters 10] [--no-bf16]
         [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SR = 8000
T = SR * 3
DEPTHS = (16, 12, 8, 6, 4, 2)
DEFAULT_CKPT = "Experiments/checkpoint/convergence_demo/best_model.pth"


def _voice(rng, f_lo, f_hi):
    """The generator's voice at a fixed length T (the JAX probe's copy)."""
    f0 = rng.uniform(f_lo, f_hi)
    t = np.arange(T) / SR
    sig = np.zeros(T, np.float32)
    for h in range(1, 4):
        if f0 * h < SR / 2 * 0.9:
            sig += rng.uniform(0.3, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t
                             + rng.uniform(0, 2 * np.pi))
    sig = (sig * env).astype(np.float32)
    return 0.2 * sig / (np.abs(sig).max() + 1e-8)


def make_tt(n):
    """The JAX probe's test set: ``(mixes (n, T), srcs (n, 2, T))``
    float32 (see the module docstring for how it differs from the
    generator's tt split)."""
    mixes, srcs = [], []
    for i in range(n):
        rng = np.random.default_rng(2 * 10 ** 6 + i)
        s1, s2 = _voice(rng, 100, 300), _voice(rng, 700, 1500)
        srcs.append(np.stack([s1, s2]))
        mixes.append(s1 + s2)
    return np.stack(mixes), np.stack(srcs)


def sisnr(est, tgt, eps=1e-8):
    """SI-SNR (dB) over the last axis, numpy."""
    est = est - est.mean(-1, keepdims=True)
    tgt = tgt - tgt.mean(-1, keepdims=True)
    proj = (np.sum(est * tgt, -1, keepdims=True)
            / (np.sum(tgt * tgt, -1, keepdims=True) + eps)) * tgt
    noise = est - proj
    return 10 * np.log10((proj ** 2).sum(-1)
                         / ((noise ** 2).sum(-1) + eps) + eps)


def pit_sisnr(ests, srcs):
    """Each utterance's SI-SNR (dB) under the better of the two source
    orders, (n,) from (n, 2, T)."""
    keep = sisnr(ests, srcs).mean(-1)
    swap = sisnr(ests[:, ::-1], srcs).mean(-1)
    return np.maximum(keep, swap)


def sisnri(ests, srcs, mixes):
    """Mean PIT SI-SNR improvement over the set (n, 2, T)."""
    base = sisnr(np.repeat(mixes[:, None], 2, 1), srcs).mean(-1)
    return float((pit_sisnr(ests, srcs) - base).mean())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def separate_at_depth(model, mixes, depth, batch, compute_dtype=None):
    """The model's estimates of ``mixes`` (n, T) at recurrence depth
    ``depth``, ``batch`` rows a forward, each row as if alone; numpy
    (n, n_src, T) in the activations' dtype (bf16 upcast to float32)."""
    from tdanet_tpu_torch.utils.separator import to_numpy
    device = next(model.parameters()).device
    outs = []
    with torch.inference_mode():
        for s in range(0, len(mixes), batch):
            x = torch.from_numpy(np.asarray(mixes[s:s + batch])).to(device)
            outs.append(to_numpy(model(x, num_blocks=depth,
                                       per_utterance=True,
                                       compute_dtype=compute_dtype)))
    return np.concatenate(outs)


def forward_seconds(model, x, depth, iters, compute_dtype=None):
    """Host wall seconds a batched forward of ``x`` at ``depth``: one warm
    forward, then ``iters``, synchronised with the card at both ends."""
    device = x.device
    kw = dict(num_blocks=depth, per_utterance=True,
              compute_dtype=compute_dtype)
    with torch.inference_mode():
        model(x, **kw)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x, **kw)
        _sync(device)
    return (time.perf_counter() - t0) / iters


def depth_rows(model, mixes, srcs, batch, iters, compute_dtype=None,
               depths=DEPTHS):
    """One row a depth: ``{"depth", "sisnri_db", "rtfx"}``, unrounded.
    Each depth runs ``ceil(n / batch)`` forwards for its quality and
    ``iters + 1`` on the first batch for its time."""
    device = next(model.parameters()).device
    xb = torch.from_numpy(np.asarray(mixes[:batch])).to(device)
    rows = []
    for depth in depths:
        ests = separate_at_depth(model, mixes, depth, batch, compute_dtype)
        dt = forward_seconds(model, xb, depth, iters, compute_dtype)
        rows.append({"depth": depth,
                     "sisnri_db": sisnri(ests, srcs, mixes),
                     "rtfx": xb.shape[0] * (T / SR) / dt})
    return rows


def load_model(ckpt, device):
    """``BaseModel.from_pretrain(ckpt)`` on ``device`` (CUDA without a
    card raises)."""
    from tdanet_tpu_torch.audio_test import resolve_device
    from tdanet_tpu_torch.models import BaseModel
    return BaseModel.from_pretrain(ckpt).to(resolve_device(device))


def add_common_args(ap, batch=25):
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")


def device_line(device):
    """The device the probe runs on, for the record (stderr)."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return f"device: {device} ({name})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 activations (--no-bf16: fp32)")
    args = ap.parse_args(argv)
    model = load_model(args.ckpt, args.device)
    print(device_line(next(model.parameters()).device), file=sys.stderr)
    mixes, srcs = make_tt(args.n)
    dtype = torch.bfloat16 if args.bf16 else None
    rows = depth_rows(model, mixes, srcs, args.batch, args.iters, dtype)
    for r in rows:
        print(json.dumps({"depth": r["depth"],
                          "sisnri_db": round(r["sisnri_db"], 2),
                          "rtfx": round(r["rtfx"], 1)}), flush=True)
    return rows


if __name__ == "__main__":
    main()
