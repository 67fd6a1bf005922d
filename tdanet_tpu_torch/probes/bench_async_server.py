"""AsyncBatchServer throughput and latency on the card (counterpart of
``scripts/bench_async_server.py``).

1. saturation (closed loop): N client threads submit and wait; the
   server's aggregate capacity with a full pipeline;
2. offered load (open loop): requests arrive at rate lambda, uniformly
   spaced; the aggregate realtime factor and latency p50/p95 at each rate.

Beside them, the forward at the served shape (max_batch rows, the clips'
padded length) eager and replayed from the server's CUDA graph: the
server always replays, so this is the A/B of the graphs.

    python -m tdanet_tpu_torch.probes.bench_async_server [--max_batch 8]
        [--bf16] [--adaptive [--min_batch B]] [--clip_s 2.0 | --var_len 1,4]
        [--length_buckets 1,2,3,4] [--deadline_ms D] [--rates r1,r2]
        [--n_requests 400] [--closed_only | --open_only]

The model is the bench configuration (``bench.py:41-44``: out 128, in
512, 16 blocks, depth 5, 4 ms, 2 sources) at ``--sr`` with seeded random
weights. Every line printed is one JSON object with the card's name and
power limit. A request that fails, or is shed with no ``--deadline_ms``,
fails the run after its loop's line.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from tdanet_tpu_torch.models import TDANetBest
from tdanet_tpu_torch.serving import AsyncBatchServer, DeadlineExceeded
from tdanet_tpu_torch.utils.timing import card_line, cuda_time


def build(sr, seed=0):
    model = TDANetBest(out_channels=128, in_channels=512, num_blocks=16,
                       upsampling_depth=5, enc_kernel_size=4,
                       num_sources=2, sample_rate=sr)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.cuda().eval()


def make_clips(sr, n, clip_s=2.0, var_len="", seed=0):
    """Fixed-length clips, or lengths uniform in [lo, hi] s (``var_len``
    "lo,hi"): at most 32 distinct clips, as the JAX bench makes them."""
    rng = np.random.default_rng(seed)
    n = min(n, 32)
    if var_len:
        lo, hi = (float(v) for v in var_len.split(","))
        secs = rng.uniform(lo, hi, n)
    else:
        secs = np.full(n, clip_s)
    return [(rng.standard_normal(int(s * sr)) * 0.1).astype(np.float32)
            for s in secs]


def _ms(lat, q):
    return float(np.percentile(lat, q)) * 1e3 if len(lat) else None


class _Outcomes:
    """Requests shed by the deadline, and those that failed otherwise
    (the first error kept)."""

    def __init__(self):
        self.shed, self.failed, self.error = 0, 0, None

    def note(self, exc):
        if isinstance(exc, DeadlineExceeded):
            self.shed += 1
        else:
            self.failed += 1
            self.error = self.error or repr(exc)

    def row(self):
        return {"shed": self.shed, "failed": self.failed,
                "error": self.error}


def check(row, deadline_ms=None):
    """Every request of a loop answered, or shed by a deadline the server
    was given: raises otherwise."""
    if row["failed"] or (deadline_ms is None and row["shed"]) \
            or row["answered"] + row["shed"] + row["failed"] \
            != row["requests"]:
        raise AssertionError(f"{row['mode']} loop: {row['answered']} of "
                             f"{row['requests']} answered, {row['shed']} "
                             f"shed, {row['failed']} failed "
                             f"({row['error']})")
    return row


def closed_loop(server, clips, n_clients, n_requests, sr):
    """Each client submits and waits: saturation capacity."""
    lat, audio_s, outcomes = [], [0.0], _Outcomes()
    lock = threading.Lock()
    counter = [0]

    def client(cid):
        k = 0
        while True:
            with lock:
                if counter[0] >= n_requests:
                    return
                counter[0] += 1
            clip = clips[(cid + k) % len(clips)]
            k += 1
            t0 = time.perf_counter()
            try:
                server.separate(clip, timeout=300)
            except Exception as e:  # noqa: BLE001 (counted, see check)
                with lock:
                    outcomes.note(e)
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                audio_s[0] += clip.shape[-1] / sr

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return {"mode": "closed", "clients": n_clients, "requests": counter[0],
            "answered": len(lat), **outcomes.row(), "wall_s": wall,
            "agg_rtfx": audio_s[0] / wall, "p50_ms": _ms(lat, 50),
            "p95_ms": _ms(lat, 95)}


def open_loop(server, clips, rate_hz, n_requests, sr):
    """Uniform arrivals at ``rate_hz``. A request's latency is stamped by a
    done-callback when the resolver answers it."""
    lat, futs, outcomes = [], [], _Outcomes()
    done_audio = [0.0]
    lock = threading.Lock()

    def submit(clip):
        ts = time.perf_counter()
        secs = clip.shape[-1] / sr
        fut = server.submit(clip)

        def cb(f, ts=ts, secs=secs):
            with lock:
                if f.exception() is not None:
                    outcomes.note(f.exception())
                    return
                lat.append(time.perf_counter() - ts)
                done_audio[0] += secs
        fut.add_done_callback(cb)
        return fut

    t0 = time.perf_counter()
    offered_audio = 0.0
    for i in range(n_requests):
        target = t0 + i / rate_hz
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        clip = clips[i % len(clips)]
        offered_audio += clip.shape[-1] / sr
        futs.append(submit(clip))
    for f in futs:
        try:
            f.result(timeout=300)
        except Exception:  # noqa: BLE001 (counted by the callback)
            pass
    wall = time.perf_counter() - t0
    # result() wakes before the done-callbacks run: wait for the last ones
    deadline = time.perf_counter() + 5.0
    while len(lat) + outcomes.shed + outcomes.failed < len(futs) \
            and time.perf_counter() < deadline:
        time.sleep(0.001)
    return {"mode": "open", "rate_hz": rate_hz, "requests": n_requests,
            "answered": len(lat), **outcomes.row(),
            "offered_rtfx": offered_audio * rate_hz / n_requests,
            "agg_rtfx": done_audio[0] / wall,
            "p50_ms": _ms(lat, 50), "p95_ms": _ms(lat, 95)}


def forward_ab(server, length, B):
    """ms of one forward at (B, length): eager ``model(...)`` and the
    server's graph replayed (median of 7 runs of CUDA-event timing)."""
    prog = server._get_fwd(server._target(length), B)
    x = torch.zeros((B, prog.length), device=server.device)
    with torch.inference_mode():
        eager, _, _ = cuda_time(
            lambda: server.model(x, num_blocks=server.num_blocks,
                                 per_utterance=True,
                                 compute_dtype=server.compute_dtype),
            reps=3, runs=7, warmup=1)
        graph, _, _ = cuda_time(prog.graph.replay, reps=10, runs=7,
                                warmup=2)
    return {"B": B, "T": prog.length, "eager_ms": eager, "graph_ms": graph}


def prewarm(server, clips, log=None):
    """The server's (length x rung) grid for these clips: the configured
    buckets, else the clips' lattice lengths (the 6 longest, as the JAX
    bench warms an exact-lattice server's hot set)."""
    targets = server.length_buckets or sorted(
        {server._target(c.shape[-1]) for c in clips})[-6:]
    t0 = time.perf_counter()
    server.prewarm(lengths=targets)
    if log:
        log(f"prewarm {len(targets)} lengths x {server._ladder}: "
            f"{time.perf_counter() - t0:.2f} s, graph pool "
            f"{server.pool_bytes() / 2 ** 20:.0f} MiB")
    return targets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--pipeline_depth", type=int, default=2)
    ap.add_argument("--clip_s", type=float, default=2.0)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--n_requests", type=int, default=400)
    ap.add_argument("--closed_only", action="store_true")
    ap.add_argument("--open_only", action="store_true",
                    help="skip the closed loop (needs --rates)")
    ap.add_argument("--rates", type=str, default="",
                    help="requests/s of the open loop; default 25-110%% "
                         "of the closed loop's saturation")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive batch-size ladder (grows under "
                         "overload toward max_batch)")
    ap.add_argument("--min_batch", type=int, default=None)
    ap.add_argument("--var_len", type=str, default="",
                    help="'lo,hi' seconds: variable-length traffic")
    ap.add_argument("--length_buckets", type=str, default="",
                    help="comma-separated bucket lengths in SECONDS for "
                         "the (length x batch) padding ladder")
    ap.add_argument("--deadline_ms", type=float, default=None,
                    help="deadline-aware admission: shed requests older "
                         "than this at dispatch time")
    args = ap.parse_args(argv)
    if args.open_only and not args.rates:
        ap.error("--open_only needs --rates")
    card = card_line()
    model = build(args.sr)
    clips = make_clips(args.sr, 32, args.clip_s, args.var_len)
    buckets = [int(float(s) * args.sr)
               for s in args.length_buckets.split(",") if s] or None
    server = AsyncBatchServer(
        model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        pipeline_depth=args.pipeline_depth,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        adaptive=args.adaptive, min_batch=args.min_batch,
        length_buckets=buckets, deadline_ms=args.deadline_ms)
    config = {k: v for k, v in vars(args).items() if v not in ("", None)}
    mean_s = float(np.mean([c.shape[-1] / args.sr for c in clips]))

    def emit(row):
        print(json.dumps({**row, "server_stats": dict(server.stats),
                          "config": config, "card": card}), flush=True)
        if "answered" in row:
            check(row, args.deadline_ms)

    try:
        prewarm(server, clips, lambda s: print(s, file=sys.stderr))
        longest = max(c.shape[-1] for c in clips)
        emit({"mode": "forward", **forward_ab(server, longest,
                                              server._ladder[-1]),
              "pool_mib": server.pool_bytes() / 2 ** 20})
        rates = [float(r) for r in args.rates.split(",") if r]
        if not args.open_only:
            row = closed_loop(server, clips, 4 * args.max_batch,
                              args.n_requests, args.sr)
            emit(row)
            rates = rates or [row["agg_rtfx"] / mean_s * f
                              for f in (0.25, 0.5, 0.75, 0.9, 1.1)]
        if not args.closed_only:
            for rate in rates:
                emit(open_loop(server, clips, rate,
                               min(args.n_requests, max(60, int(rate * 15))),
                               args.sr))
    finally:
        server.close()


if __name__ == "__main__":
    sys.exit(main())
