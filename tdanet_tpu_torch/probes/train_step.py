"""The training recipe's step on the card: its time and peak memory with
and without per-iteration checkpointing, its launches of kernel #1, and a
profile.

    python -m tdanet_tpu_torch.probes.train_step [--batch 8]
        [--remat on,off] [--out record.json]

The recipe is ``configs/tdanet.yml``: TDANetBest out 128, in 512, 16
blocks, depth 5, 4 ms encoder, 2 sources, 8 kHz, 3 s segments, bf16
activations over fp32 parameters, PIT neg-SNR with threshold_byloss, Adam
2e-3 with a global-norm clip of 5, dropout and drop-path on. A step is
forward, loss, backward, clip and update, timed on the host clock around
work that ends in a synchronize (median of 5 after 2 warm-up steps); the
peak is ``torch.cuda.max_memory_allocated`` over those steps.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_backward)
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.system.optimizers import make_optimizer
from tdanet_tpu_torch.system.trainer import (create_train_state,
                                             make_train_step)
from tdanet_tpu_torch.utils.timing import card_line

RECIPE = dict(out_channels=128, in_channels=512, num_blocks=16,
              upsampling_depth=5, enc_kernel_size=4, num_sources=2,
              sample_rate=8000)
FORWARD_NAME = "dw_conv_glob_ln_kernel"    # device kernels of #1
BACKWARD_NAME = "dw_conv_glob_ln_backward_kernel"


def tone_batch(B, seconds=3.0, sr=8000, seed=0):
    """(mixtures (B, T), sources (B, 2, T)): two tones plus noise a row."""
    rng = np.random.default_rng(seed)
    T = int(seconds * sr)
    t = np.arange(T) / sr
    src = np.stack([np.stack([
        0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                     + rng.uniform(0, 6)) + 0.02 * rng.standard_normal(T)
        for _ in range(2)]) for _ in range(B)]).astype(np.float32)
    return torch.from_numpy(src.sum(1)).cuda(), torch.from_numpy(src).cuda()


def setup(remat, seed=0, **overrides):
    """(state, step) of the recipe on the card, weights from ``seed``."""
    from tdanet_tpu_torch.models import TDANetBest
    model = TDANetBest(**{**RECIPE, **overrides}, remat=remat)
    tx = make_optimizer("adam", lr=2e-3, grad_clip=5.0)
    state = create_train_state(model, tx,
                               torch.Generator().manual_seed(seed),
                               device="cuda")
    step = make_train_step(model, PITLossWrapper(pairwise_neg_snr,
                                                 threshold_byloss=True), tx,
                           compute_dtype=torch.bfloat16)
    return state, step


def counts():
    return dw_conv_glob_ln.launches, dw_conv_glob_ln_backward.launches


def time_steps(B, remat, steps=5, warmup=2):
    """The step's median ms over ``steps`` after ``warmup``, its runs, the
    peak allocated bytes, and #1's forward and backward launches per
    step."""
    state, step = setup(remat)
    mix, src = tone_batch(B)
    for i in range(warmup):
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    before = counts()
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(100 + i))
        loss.item()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    per_step = tuple((a - b) // steps for a, b in zip(counts(), before))
    row = dict(B=B, remat=bool(remat), ms=statistics.median(runs),
               runs=runs, peak_bytes=torch.cuda.max_memory_allocated(),
               launches_per_step=per_step, loss=loss.item())
    print(f"train step B={B} 3 s bf16 checkpointing "
          f"{'on' if remat else 'off'}: median {row['ms']:.1f} ms (runs "
          f"{[round(r, 1) for r in runs]}), peak "
          f"{row['peak_bytes'] / 2**30:.2f} GiB allocated; #1 launches per "
          f"step forward {per_step[0]}, backward {per_step[1]} "
          f"[{card_line()}]", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return row


def profile_step(B, remat):
    """One profiled step after a warm-up: device kernels, device ms, and
    #1's forward and backward kernels and device ms."""
    from torch.profiler import ProfilerActivity, profile
    state, step = setup(remat)
    mix, src = tone_batch(B)
    state, loss = step(state, mix, src, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, mix, src,
                           torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731 (ms)
    pick = lambda name: [e for e in events if name in e.key]  # noqa: E731
    fwd, bwd = pick(FORWARD_NAME), pick(BACKWARD_NAME)
    result = dict(kernels=sum(e.count for e in events),
                  device_ms=sum(dev(e) for e in events), wall_ms=wall,
                  forward_kernels=sum(e.count for e in fwd),
                  forward_ms=sum(dev(e) for e in fwd),
                  backward_kernels=sum(e.count for e in bwd),
                  backward_ms=sum(dev(e) for e in bwd),
                  top=[(dev(e), e.count, e.key[:90]) for e in
                       sorted(events, key=dev, reverse=True)[:10]])
    print(f"profiled train step B={B} checkpointing "
          f"{'on' if remat else 'off'}: {result['kernels']} device kernels,"
          f" {result['device_ms']:.2f} ms device time in {wall:.1f} ms wall "
          f"(profiler on); #1 forward {result['forward_kernels']} kernels "
          f"{result['forward_ms']:.2f} ms, backward "
          f"{result['backward_kernels']} kernels {result['backward_ms']:.2f}"
          f" ms [{card_line()}]")
    for ms, n, key in result["top"]:
        print(f"  {ms:8.3f} ms {n:5d}x {key}")
    del state, step
    torch.cuda.empty_cache()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", default="on,off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    print(card_line())
    rows = [time_steps(args.batch, flag == "on")
            for flag in args.remat.split(",")]
    record = dict(card=card_line(), rows=rows,
                  profile=profile_step(args.batch, True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
