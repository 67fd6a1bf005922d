"""Progressive (adaptive-depth) separation study (counterpart of
``scripts/probe_progressive.py``), on the early-exit probe's test set
(:func:`probe_early_exit.make_tt`).

1. The proxy: is stage 1's convergence proxy (the recurrence's relative
   change in its last iteration at depth d1) predictive of which
   utterances gain from the remaining 16 - d1 iterations? One line
   ``{"proxy": {"d1", "pearson_r", "spearman_r", "gain_db_mean",
   "delta_min", "delta_max"}}`` over the per-utterance gain
   ``pit_sisnr@16 - pit_sisnr@d1``.
2. The fixed depths 16 and d1: ``{"fixed": {"depth", "sisnri_db",
   "rtfx"}}``.
3. The operating curve: at the thresholds of the deltas' quantiles
   (0.9, 0.75, 0.5, 0.25, 0.1), ``{"threshold_q", "threshold",
   "escalated_frac", "sisnri_db", "rtfx", "vs16_db"}`` of
   ``progressive.separate_progressive``.

Every RTFx is ``n * 3 s`` over the host's wall clock of one whole pass
(one warm pass first, then ``--iters``), estimates read back to the host
in every arm; the progressive pass also reads each stage-1 batch's deltas
for its host-side decision. The forwards are eager, so the clock may be
bound by the host.

Usage: python -m tdanet_tpu_torch.scripts.probe_progressive [--d1 8]
         [--n 100] [--batch 25] [--iters 5] [--no-bf16] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tdanet_tpu_torch.scripts.probe_early_exit import (
    SR, T, add_common_args, device_line, load_model, make_tt, pit_sisnr,
    separate_at_depth, sisnri)

QUANTILES = (0.9, 0.75, 0.5, 0.25, 0.1)


def _timed(fn, iters, device):
    """Wall seconds of one ``fn()`` after a warm call; ``fn`` returns
    host arrays, so every call ends with its estimates on the host."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters


def proxy(model, mixes, srcs, d1, batch, compute_dtype=None):
    """(gain, delta, est_full, est_d1): each utterance's PIT SI-SNR gain
    from depth ``d1`` to the model's full depth, and its stage-1 delta
    from ``separate_progressive`` with nothing escalated."""
    from tdanet_tpu_torch.progressive import separate_progressive
    depth_full = model.num_blocks
    est_full = separate_at_depth(model, mixes, depth_full, batch,
                                 compute_dtype)
    est_d1 = separate_at_depth(model, mixes, d1, batch, compute_dtype)
    gain = pit_sisnr(est_full, srcs) - pit_sisnr(est_d1, srcs)
    _, info = separate_progressive(model, mixes, depth1=d1,
                                   depth_full=depth_full, threshold=np.inf,
                                   batch_size=batch,
                                   compute_dtype=compute_dtype)
    return gain, info["delta"], est_full, est_d1


def rank_r(a, b):
    """Spearman's r as the JAX probe takes it: Pearson's r of the ranks."""
    return float(np.corrcoef(np.argsort(np.argsort(a)),
                             np.argsort(np.argsort(b)))[0, 1])


def study(model, mixes, srcs, d1, batch, iters, compute_dtype=None,
          quantiles=QUANTILES):
    """The three parts at the model's full depth (16 for the recipe);
    returns ``(lines, census)``: the printed dicts, unrounded, and each
    separation's ``(depth, rows)`` in the order run (stage 2 at ``full -
    d1``), for a caller that counts the block iterations the study ran
    (``rows`` go ``batch`` to a forward)."""
    from tdanet_tpu_torch.progressive import separate_progressive
    device = next(model.parameters()).device
    n, full = len(mixes), model.num_blocks
    census = []

    def fixed(depth):
        census.append((depth, n))
        return separate_at_depth(model, mixes, depth, batch, compute_dtype)

    census += [(full, n), (d1, n), (d1, n)]
    gain, delta, est16, est_d1 = proxy(model, mixes, srcs, d1, batch,
                                       compute_dtype)
    lines = [{"proxy": {"d1": d1,
                        "pearson_r": float(np.corrcoef(delta, gain)[0, 1]),
                        "spearman_r": rank_r(delta, gain),
                        "gain_db_mean": float(gain.mean()),
                        "delta_min": float(delta.min()),
                        "delta_max": float(delta.max())}}]
    q16 = sisnri(est16, srcs, mixes)
    for depth, q in ((full, q16), (d1, sisnri(est_d1, srcs, mixes))):
        dt = _timed(lambda: fixed(depth), iters, device)
        lines.append({"fixed": {"depth": depth, "sisnri_db": q,
                                "rtfx": n * (T / SR) / dt}})

    def progressive(thr):
        ests, info = separate_progressive(
            model, mixes, depth1=d1, threshold=thr, batch_size=batch,
            compute_dtype=compute_dtype)
        census.extend([(d1, n), (full - d1, info["n_escalated"])])
        return ests, info

    for q in quantiles:
        thr = float(np.quantile(delta, q))
        ests, info = progressive(thr)
        quality = sisnri(ests, srcs, mixes)
        dt = _timed(lambda: progressive(thr), iters, device)
        lines.append({"threshold_q": q, "threshold": thr,
                      "escalated_frac": info["n_escalated"] / n,
                      "sisnri_db": quality, "rtfx": n * (T / SR) / dt,
                      "vs16_db": quality - q16})
    return lines, census


def rounded(line):
    """A line as the JAX probe prints it."""
    if "proxy" in line:
        p = line["proxy"]
        return {"proxy": {"d1": p["d1"],
                          "pearson_r": round(p["pearson_r"], 3),
                          "spearman_r": round(p["spearman_r"], 3),
                          "gain_db_mean": round(p["gain_db_mean"], 3),
                          "delta_min": round(p["delta_min"], 4),
                          "delta_max": round(p["delta_max"], 4)}}
    if "fixed" in line:
        f = line["fixed"]
        return {"fixed": {"depth": f["depth"],
                          "sisnri_db": round(f["sisnri_db"], 2),
                          "rtfx": round(f["rtfx"], 1)}}
    return {"threshold_q": line["threshold_q"],
            "threshold": round(line["threshold"], 4),
            "escalated_frac": round(line["escalated_frac"], 3),
            "sisnri_db": round(line["sisnri_db"], 2),
            "rtfx": round(line["rtfx"], 1),
            "vs16_db": round(line["vs16_db"], 2)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--d1", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 activations (--no-bf16: fp32)")
    args = ap.parse_args(argv)
    model = load_model(args.ckpt, args.device)
    print(device_line(next(model.parameters()).device), file=sys.stderr)
    mixes, srcs = make_tt(args.n)
    dtype = torch.bfloat16 if args.bf16 else None
    lines, census = study(model, mixes, srcs, args.d1, args.batch,
                          args.iters, dtype)
    for line in lines:
        print(json.dumps(rounded(line)), flush=True)
    return lines, census


if __name__ == "__main__":
    main()
