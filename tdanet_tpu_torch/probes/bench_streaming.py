"""Multi-stream online serving latency on the card (counterpart of
``scripts/bench_streaming.py``).

p50/p90/p99 per-hop latency of N concurrent 16 kHz streams through
MultiStreamSeparator's one batched forward (the bench model: out 128, in
512, 16 blocks, depth 5, 4 ms; seeded random weights), 1 s segments,
overlap 0.25 (750 ms hops), bf16, int16 emission. The engine replays its
CUDA graph; beside it the same hop with the eager forward at the same
shape (host batch to the card, ``model(...)``, int16, back to the host).

    python -m tdanet_tpu_torch.probes.bench_streaming [n_streams] [iters]

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tdanet_tpu_torch.probes.bench_async_server import build
from tdanet_tpu_torch.serving import MultiStreamSeparator, pcm16
from tdanet_tpu_torch.utils.timing import card_line

SR = 16000
SEGMENT, OVERLAP = 1.0, 0.25


def _percentiles(lat):
    return {f"p{q}_ms": float(np.percentile(lat, q)) for q in (50, 90, 99)}


def hop_latency(model, n_streams, iters, seed=0):
    """Per-hop ms of ``iters`` steps, every stream fed one hop a step:
    (graph percentiles, eager percentiles)."""
    multi = MultiStreamSeparator(model, max_streams=n_streams,
                                 segment=SEGMENT, overlap=OVERLAP,
                                 sample_rate=SR,
                                 compute_dtype=torch.bfloat16,
                                 emit_dtype="int16")
    rng = np.random.default_rng(seed)
    for i in range(n_streams):
        multi.open(i)
        multi.push(i, (rng.standard_normal(SR) * 0.1).astype(np.float32))
    multi.step()  # the first segment of every stream
    hop = int(SR * (1 - OVERLAP))
    lat = []
    for _ in range(iters):
        for i in range(n_streams):
            multi.push(i, (rng.standard_normal(hop) * 0.1)
                       .astype(np.float32))
        t0 = time.perf_counter()
        out = multi.step()
        lat.append((time.perf_counter() - t0) * 1e3)
        if len(out) != n_streams:
            raise AssertionError(f"{len(out)} streams answered a hop, "
                                 f"expected {n_streams}")
    batch = np.zeros((n_streams, multi.seg_len), np.float32)
    eager = []
    with torch.inference_mode():
        for k in range(iters + 2):
            t0 = time.perf_counter()
            x = torch.from_numpy(batch).cuda()
            pcm16(model(x, per_utterance=True,
                        compute_dtype=torch.bfloat16)).cpu()
            if k >= 2:  # two warm-up hops
                eager.append((time.perf_counter() - t0) * 1e3)
    return _percentiles(lat), _percentiles(eager), multi.stats


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_streams = int(argv[0]) if argv else 4
    iters = int(argv[1]) if len(argv) > 1 else 50
    card = card_line()
    graph, eager, stats = hop_latency(build(SR), n_streams, iters)
    print(json.dumps({"n_streams": n_streams, "iters": iters,
                      "segment_s": SEGMENT, "hop_ms": 1e3 * SEGMENT
                      * (1 - OVERLAP), "dtype": "bf16", "emit": "int16",
                      "graph": graph, "eager": eager, "stats": stats,
                      "card": card}))


if __name__ == "__main__":
    sys.exit(main())
