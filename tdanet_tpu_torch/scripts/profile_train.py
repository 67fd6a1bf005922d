"""Profile the training recipe's step on the card and attribute its device
time to kernels (counterpart of ``scripts/profile_train.py``).

Usage: python -m tdanet_tpu_torch.scripts.profile_train [mode] [outdir]
         [--optim NAME]
  mode: full | scales | none (the checkpoint policy; default full)

The step is the recipe's (``configs/tdanet.yml``): TDANetBest out 128, in
512, 16 blocks, depth 5, 8 kHz, B 8 of 3 s, bf16 activations over fp32
weights, PIT neg-SNR with threshold_byloss, a global-norm clip of 5 and
the optimizer ``--optim`` (default adam) at 2e-3 from the port's factory,
on seeded normal noise. After one untimed step (the first calls), it
takes 5 steps under the profiler (``timing.profiled``) and prints ms per
step on the host clock around them (profiler on), writes a Chrome trace
to ``outdir`` and prints the device time by kernel name, the top 30. The
window's #1 kernels are held to the wrappers' launches
(``timing.counted_windows``: a short window is read once more).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_backward)
from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
from tdanet_tpu_torch.models import TDANetBest
from tdanet_tpu_torch.probes.train_step import (BACKWARD_NAME, FORWARD_NAME,
                                                RECIPE)
from tdanet_tpu_torch.system.optimizers import make_optimizer
from tdanet_tpu_torch.system.trainer import (create_train_state,
                                             make_train_step)
from tdanet_tpu_torch.utils.timing import (card_line, counted_windows,
                                           device_kernels, profiled)

MODES = {"full": True, "scales": "scales", "none": False}
TOP = 30
B, SECONDS = 8, 3.0


def _launches():
    return dw_conv_glob_ln.launches + dw_conv_glob_ln_backward.launches


def profile(mode="full", outdir="build/train_trace", optim="adam", iters=5,
            log=print):
    """Run the profile; returns its record (ms a step, the trace's path,
    the kernels' total and top rows, #1's launches)."""
    model = TDANetBest(**RECIPE, remat=MODES[mode])
    tx = make_optimizer(optim, lr=2e-3, grad_clip=5.0)
    state = create_train_state(model, tx, torch.Generator().manual_seed(0),
                               device="cuda")
    step = make_train_step(model, PITLossWrapper(pairwise_neg_snr,
                                                 threshold_byloss=True),
                           tx, compute_dtype=torch.bfloat16)
    T = int(RECIPE["sample_rate"] * SECONDS)
    gen = torch.Generator().manual_seed(1)
    mix = torch.randn(B, T, generator=gen).cuda()
    src = torch.randn(B, 2, T, generator=gen).cuda()
    t0 = time.perf_counter()
    state, loss = step(state, mix, src, torch.Generator().manual_seed(3))
    log(f"first step (first calls) in {time.perf_counter() - t0:.1f} s, "
        f"loss {loss.item():.4f}")
    os.makedirs(outdir, exist_ok=True)
    trace = os.path.join(outdir, f"train_step_{mode}_{optim}.json")

    def read():
        nonlocal state
        before = _launches()
        t0 = time.perf_counter()
        with profiled() as prof:
            for i in range(iters):
                state, out = step(state, mix, src,
                                  torch.Generator().manual_seed(10 + i))
            out.item()
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        launched = _launches() - before
        rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                       for e in device_kernels(prof)), reverse=True)
        dw = sum(n for _, n, key in rows
                 if FORWARD_NAME in key or BACKWARD_NAME in key)
        return dw, launched, (ms, prof, rows, launched)

    ms, prof, rows, launched = counted_windows(
        read, f"profile_train {mode} {optim}")
    prof.prof.export_chrome_trace(trace)
    total = sum(r[0] for r in rows)
    log(f"[{mode}] {ms:.1f} ms/step while tracing ({optim}, B={B} "
        f"{SECONDS:g} s; {card_line()})")
    log(f"trace -> {trace}")
    log(f"device time by kernel, top {TOP} of {len(rows)} ({total:.2f} ms "
        f"over {iters} steps):")
    for ms_k, n, key in rows[:TOP]:
        log(f"  {ms_k:9.3f} ms {n:6d}x {key[:100]}")
    return dict(mode=mode, optim=optim, card=card_line(), ms_per_step=ms,
                trace=trace, kernels=sum(r[1] for r in rows), total_ms=total,
                dw_launches=launched,
                top=[[round(m, 4), n, k[:100]] for m, n, k in rows[:TOP]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="full", choices=list(MODES))
    ap.add_argument("outdir", nargs="?", default="build/train_trace")
    ap.add_argument("--optim", default="adam")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: the profile times the card")
    return profile(args.mode, args.outdir, args.optim)


if __name__ == "__main__":
    sys.exit(main() and 0)
