"""The serving slice on the card, phases 20 and 21 of ``chip_smoke.py``:
the four engines of ``tdanet_tpu_torch/serving.py`` over a full-width
TDANetBest (the bench configuration, ``bench.py:41-44``: out 128, in 512,
16 blocks, depth 5, 4 ms, 2 sources, 16 kHz), checked against the eager
paths, with kernel #1's launches counted; then their times.

    python -m tdanet_tpu_torch.probes.serve_path [--out record.json]

Alone, it serves seeded random weights; ``chip_smoke.py`` gives it the
checkpoint its phase 4 saved, loaded with ``from_pretrain``.

Phase 20 (:func:`drive_serve`): first #1 against its plain version at
every depthwise site the forwards of phases 20 and 21 run (fp32 and bf16,
every row count an engine's graph has, :func:`serve_combos`); then,
from #1's launch counts at 0, inside a recording of the sites #1 is
called at:

- StreamingSeparator, fp32, 1 s segments, overlap 0.25: a 7.3 s mixture
  pushed in ragged chunks, against ``utils.css.stitch_segments`` of the
  reference's slicing (eager, batch 8): >= 60 dB, the input's length;
- MultiStreamSeparator, 4 streams of 2.3-5.2 s: each stream against the
  StreamingSeparator's: >= 60 dB; the same in bf16 with int16 emission:
  each graph forward against the eager bf16 forward of its batch
  (>= 60 dB), and its SNR against the fp32 streams printed;
- AsyncBatchServer, the ladder 8/16/24 with length buckets of 1.024,
  2.048, 3.072 and 4.096 s, rung 0 prewarmed: 48 requests of 1-4 s from 8
  client threads, then 48 at once (a standing queue grows the rung on the
  background thread); each answer against ``separate_batched`` padded
  the same way: >= 60 dB; the rung grew; once its graphs are built, 48
  requests of one bucket at once: a batch went through a grown rung, no
  background build failed, each answer >= 60 dB; the grid prewarmed, the
  pool's size; one more burst of 48 in a profiled window;
- a 1 ms deadline under a burst: some request shed, every other one
  answered (>= 60 dB);
- ``close`` resolves every queued future; a malformed submit raises.

#1's launches through its wrapper are exactly 2 x 32 x 16 for each graph
(the set-up forward and the capture), every site the engines called it at
was among those checked, and the device launched it 32 x 16 times per
replay: in the profiled window the profiler's count of device kernels
named dw_conv_glob_ln equals the window's replays x 512.

Phase 21 (:func:`time_serve`), its sites recorded and held to those
checked, every request answered (none shed, none failed): MultiStream
per-hop p50/p90/p99 at 1, 4 and 8 streams (bf16, int16) beside the eager
hop; AsyncBatchServer's closed loop (2 s clips, fp32 and bf16, max_batch
8 fixed and the ladder to 24) and its open loop at 50% and 90% of the
measured saturation, the forward eager and replayed at the top rung; a
lone 2 s request's latency (a B=1 graph, and the fixed server's B=8); the
device's busy share in one
profiled closed-loop window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.probes import bench_async_server as bench
from tdanet_tpu_torch.probes.bench_streaming import hop_latency
from tdanet_tpu_torch.probes.deploy_serve import RAGGED, drive_streams
from tdanet_tpu_torch.probes.dw_sites import block_sites
from tdanet_tpu_torch.probes.eval_path import (
    check_sites, expect_checked, recorded_sites, sites_per_block)
from tdanet_tpu_torch.serving import (
    AsyncBatchServer, DeadlineExceeded, MultiStreamSeparator,
    StreamingSeparator, pcm16)
from tdanet_tpu_torch.utils import separate_batched
from tdanet_tpu_torch.utils.css import stitch_segments
from tdanet_tpu_torch.utils.timing import (card_line, profile_window,
                                          snr_db)

SR = 16000
CFG = dict(out_channels=128, in_channels=512, num_blocks=16,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
SEGMENT, OVERLAP = 1.0, 0.25
STREAM_SECONDS = 7.3
MULTI_SECONDS = (2.3, 3.1, 4.6, 5.2)
BUCKET = 16384  # the buckets: multiples of 16 lattice cells (1.024 s)
BUCKETS = (BUCKET, 2 * BUCKET, 3 * BUCKET, 4 * BUCKET)
LADDER = dict(max_batch=24, min_batch=8)  # 8, 16, 24
CLIENTS, REQUESTS = 8, 48
BF16 = "torch.bfloat16"


def _mix(T, rng):
    """Two tones (each a new pitch every 2 s) plus noise."""
    t = np.arange(T) / SR
    out = 0.02 * rng.standard_normal(T)
    for _ in range(2):
        f = rng.uniform(80, 400, size=int(T // (2 * SR)) + 1)
        out += 0.3 * np.sin(np.cumsum(2 * np.pi * f[(t // 2).astype(int)]
                                      / SR) + rng.uniform(0, 6))
    return out.astype(np.float32)


def _snr(ref, est):
    """The lower SNR of the sources of two (n_src, T) arrays."""
    return min(snr_db(torch.from_numpy(np.asarray(ref[s], np.float64)),
                      torch.from_numpy(np.asarray(est[s], np.float64)))
               for s in range(len(ref)))


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def serve_combos(model):
    """Every (length, rows, dtype) a forward of phases 20 and 21 runs at:
    the streaming engines' 1 s segments (one stream, 4 fp32 and bf16, the
    hops' 1 and 8 bf16), the buckets through the ladder, the 2 s clips'
    lattice length through both dtypes' servers and a lone B=1 request."""
    f32, seg_len = "torch.float32", int(SEGMENT * SR)
    clip = -(-2 * SR // model.lcm) * model.lcm
    combos = [(seg_len, 1, f32), (seg_len, 4, f32)]
    combos += [(seg_len, B, BF16) for B in (1, 4, 8)]
    combos += [(L, B, f32) for L in BUCKETS for B in (8, 16, 24)]
    combos += [(clip, B, dtype) for B in (8, 16, 24) for dtype in (f32, BF16)]
    return combos + [(clip, 1, f32)]


def serve_sites(model, combos):
    """The site keys (B, T, K, stride, bias, T innermost, dtype) of
    forwards of B rows of a length-L input in dtype, for each (L, B, dtype)
    of ``combos``, in the model's (B, C, T) layout."""
    device = next(model.parameters()).device
    keys = set()
    with torch.inference_mode():
        for length, B, dtype in combos:
            T0 = model._front(torch.zeros(1, length, device=device))[0] \
                .shape[-1]
            keys |= {(B, T, K, stride, bias, True, dtype)
                     for T, K, stride, bias in set(block_sites(
                         T0, model.upsampling_depth))}
    return keys


def check_bf16_sites(keys, C, seed=1):
    """#1 against its plain version at bf16 sites (bf16 x in the model's
    layout, fp32 parameters as the bf16 forward passes them), plain in
    fp32 on the same bf16 values: phase 3's limit, SNR >= 40 dB."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    low = float("inf")
    with torch.inference_mode():
        for B, T, K, stride, bias, _, _ in sorted(keys):
            x = randn(B, C, T).bfloat16().transpose(1, 2)
            params = (randn(C, 1, K) * 0.2, randn(C) * 0.1 if bias else
                      None, randn(C), randn(C))
            got = dw_conv_glob_ln(x, *params, stride=stride, K=K)
            ref = dw_conv_glob_ln_reference(x.float(), *params,
                                            stride=stride, K=K)
            low = min(low, snr_db(ref, got))
            _expect(low >= 40.0, f"#1 bf16 disagrees with plain at B={B} "
                                 f"T={T} K={K} s={stride}: {low:.1f} dB")
    torch.cuda.synchronize()
    print(f"  #1 against plain at the {len(keys)} bf16 site shapes: SNR at "
          f"least {low:.1f} dB (limit 40)")
    return low


def reference_slices(wav, seg_len, overlap_len):
    """The reference's LibriCSS slicing: segments of seg_len every hop,
    the last zero-padded; (segments, pad)."""
    segs, start, pad = [], 0, 0
    while start < len(wav):
        s = wav[start:start + seg_len]
        if start + seg_len > len(wav):
            pad = start + seg_len - len(wav)
            s = np.concatenate([s, np.zeros(pad, np.float32)])
            start += pad
        segs.append(s)
        start += seg_len - overlap_len
    return segs, pad


def _push_ragged(engine, wav):
    outs, pos, k = [], 0, 0
    while pos < len(wav):
        chunk = wav[pos:pos + RAGGED[k % len(RAGGED)]]
        pos, k = pos + len(chunk), k + 1
        outs.append(engine.push(chunk))
    outs.append(engine.flush())
    return np.concatenate(outs, axis=1)


def _recording(multi):
    """Wrap an engine's batched forward to keep each (batch, estimates)."""
    seen, dispatch = [], multi._dispatch

    def record(segs):
        est = dispatch(segs)
        batch = np.zeros((multi.max_streams, multi.seg_len), np.float32)
        batch[:len(segs)] = np.stack(segs)
        seen.append((batch, est, len(segs)))
        return est

    multi._dispatch = record
    return seen


def _answers(futs, timeout=300):
    """(results or None, exceptions or None) of futures."""
    out = []
    for f in futs:
        try:
            out.append((f.result(timeout=timeout), None))
        except Exception as e:  # noqa: BLE001 (sorted by the caller)
            out.append((None, e))
    return out


def _wait_builds(server, timeout=120):
    t0 = time.perf_counter()
    while server._compile_sched or not server._compile_q.empty():
        _expect(time.perf_counter() - t0 < timeout,
                "background rung builds did not finish")
        time.sleep(0.05)


def drive_serve(model, seed=20):
    """Phase 20 on ``model`` (on the card, fp32). Returns the record."""
    rng = np.random.default_rng(seed)
    per_forward = sites_per_block(model) * model.num_blocks
    C = model.in_channels
    seg_len = int(SEGMENT * SR)
    overlap_len = int(seg_len * OVERLAP)
    f32 = "torch.float32"
    keys = serve_sites(model, serve_combos(model))
    check_sites({k for k in keys if k[-1] == f32}, C, "serving fp32")
    bf16_low = check_bf16_sites({k for k in keys if k[-1] == BF16}, C)

    # the references, eager on the card, before the counted runs
    t0 = time.perf_counter()
    wav = _mix(int(STREAM_SECONDS * SR), rng)
    segs, pad = reference_slices(wav, seg_len, overlap_len)
    stitched = stitch_segments(model, segs, overlap_len)
    stitched = stitched[:, :stitched.shape[1] - pad]
    multi_wavs = [_mix(int(s * SR), rng) for s in MULTI_SECONDS]
    requests = [_mix(int(s * SR), rng) for s in rng.uniform(1, 4, REQUESTS)]
    want = separate_batched(model, requests, batch_size=8, lattice=BUCKET)
    clips = [_mix(2 * SR, rng) for _ in range(8)]
    clip_want = separate_batched(model, clips)
    torch.cuda.synchronize()
    print(f"  references (eager): {time.perf_counter() - t0:.2f} s")

    record, graphs, replays = {}, 0, 0
    torch.cuda.synchronize()
    dw_conv_glob_ln.launches = 0
    t0 = time.perf_counter()
    with recorded_sites() as seen:
        stream = StreamingSeparator(model, segment=SEGMENT, overlap=OVERLAP,
                                    sample_rate=SR)
        got = _push_ragged(stream, wav)
        _expect(got.shape == (2, len(wav)), f"stream out {got.shape}")
        record["stream_vs_stitch_db"] = _snr(stitched, got)
        _expect(record["stream_vs_stitch_db"] >= 60.0,
                f"streaming vs stitch_segments: "
                f"{record['stream_vs_stitch_db']:.2f} dB")

        multi = MultiStreamSeparator(model, max_streams=4, segment=SEGMENT,
                                     overlap=OVERLAP, sample_rate=SR)
        multi_out = drive_streams(multi, multi_wavs)
        singles = [_push_ragged(stream, w) for w in multi_wavs]
        record["multi_vs_single_db"] = min(
            _snr(s, m) for s, m in zip(singles, multi_out))
        _expect(all(m.shape == (2, len(w))
                    for m, w in zip(multi_out, multi_wavs)),
                "multistream lengths")
        _expect(record["multi_vs_single_db"] >= 60.0,
                f"multistream vs streaming: "
                f"{record['multi_vs_single_db']:.2f} dB")

        m16 = MultiStreamSeparator(model, max_streams=4, segment=SEGMENT,
                                   overlap=OVERLAP, sample_rate=SR,
                                   compute_dtype=torch.bfloat16,
                                   emit_dtype="int16")
        batches = _recording(m16)
        pcm = drive_streams(m16, multi_wavs)
        _expect(all(p.dtype == np.int16 for p in pcm), "int16 emission")
        for engine in (stream, multi, m16):
            graphs += engine.stats["graphs"]
            replays += engine.stats["replays"]

        server = AsyncBatchServer(model, adaptive=True,
                                  length_buckets=BUCKETS, **LADDER)
        server.prewarm(rungs=[LADDER["min_batch"]])
        record["pool_mib_rung0"] = server.pool_bytes() / 2 ** 20
        print(f"  AsyncBatchServer: ladder {server._ladder}, buckets "
              f"{server.length_buckets}; rung 0 prewarmed, graph pool "
              f"{record['pool_mib_rung0']:.0f} MiB")
        answers = [None] * REQUESTS

        def client(c):
            for i in range(c, REQUESTS, CLIENTS):
                answers[i] = server.separate(requests[i], timeout=300)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        _expect(all(a is not None for a in answers), "a client's request "
                                                     "went unanswered")
        burst = [r for r, _ in _answers([server.submit(w)
                                         for w in requests])]
        record["async_vs_batched_db"] = min(
            _snr(w, a) for w, a in zip(want * 2, answers + burst))
        _expect(record["async_vs_batched_db"] >= 60.0,
                f"AsyncBatchServer vs separate_batched: "
                f"{record['async_vs_batched_db']:.2f} dB")
        _expect(server.stats["rung_highwater"] >= 1,
                f"the rung never grew: {server.stats}")
        _wait_builds(server)
        # the grown rung's graphs, built on the background thread, serve:
        # 48 requests of one bucket at once fill its batches
        grown = _answers([server.submit(c) for c in clips * 6])
        record["async_grown_db"] = min(
            _snr(clip_want[i % 8], a) for i, (a, _) in enumerate(grown))
        record["async_stats"] = dict(server.stats)
        _expect(record["async_grown_db"] >= 60.0,
                f"the grown rung's answers vs separate_batched: "
                f"{record['async_grown_db']:.2f} dB")
        _expect(server.stats["build_errors"] == 0
                and server.stats["max_B"] > LADDER["min_batch"],
                f"no batch went through a grown rung: {server.stats}, "
                f"{server.build_errors}")
        _wait_builds(server)
        server.prewarm()
        record["pool_mib_grid"] = server.pool_bytes() / 2 ** 20
        record["grid_graphs"] = server.stats["graphs"]
        before = server.stats["replays"]
        third, dw_kernels, _, _, _ = profile_window(
            lambda: _answers([server.submit(w) for w in requests]))
        window = server.stats["replays"] - before
        record["profiled_replays"] = window
        record["profiled_dw_kernels"] = dw_kernels
        _expect(dw_kernels == window * per_forward,
                f"{dw_kernels} dw_conv_glob_ln device kernels in a window "
                f"of {window} replays, expected {window * per_forward}")
        _expect(min(_snr(w, a) for w, (a, _) in zip(want, third)) >= 60.0,
                "the profiled burst disagrees with separate_batched")
        server.close()
        graphs += server.stats["graphs"]
        replays += server.stats["replays"]
        print(f"  grid of {server.stats['graphs']} graphs, pool "
              f"{record['pool_mib_grid']:.0f} MiB; {server.stats}")

        late = AsyncBatchServer(model, max_batch=8, deadline_ms=1.0)
        late.prewarm(lengths=[2 * SR])
        got = _answers([late.submit(c) for c in clips * 4])
        late.close()
        shed = sum(isinstance(e, DeadlineExceeded) for _, e in got)
        served = [(i % 8, r) for i, (r, e) in enumerate(got) if e is None]
        record["deadline_shed"], record["deadline_served"] = shed, len(served)
        _expect(shed >= 1 and shed + len(served) == len(got),
                f"1 ms deadline: {shed} shed, {len(served)} served of "
                f"{len(got)}")
        if served:
            _expect(min(_snr(clip_want[i], r) for i, r in served) >= 60.0,
                    "a request served under the deadline disagrees")
        graphs += late.stats["graphs"]
        replays += late.stats["replays"]

        closing = AsyncBatchServer(model, max_batch=8)
        closing.prewarm(lengths=[2 * SR])
        for bad in (np.zeros((2, SR), np.float32), np.zeros(0, np.float32)):
            try:
                closing.submit(bad)
                raise AssertionError(f"a malformed submit {bad.shape} "
                                     f"was taken")
            except ValueError:
                pass
        futs = [closing.submit(c) for c in clips * 2]
        closing.close()
        got = _answers(futs, timeout=60)
        record["close_served"] = sum(e is None for _, e in got)
        _expect(all(e is None or isinstance(e, RuntimeError)
                    for _, e in got), "close left a future unresolved or "
                                      "failed it with another error")
        try:
            closing.submit(clips[0])
            raise AssertionError("a closed server took a request")
        except RuntimeError:
            pass
        graphs += closing.stats["graphs"]
        replays += closing.stats["replays"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrapper = dw_conv_glob_ln.launches
    expect_checked(seen, keys, "serving")
    _expect(wrapper == 2 * graphs * per_forward,
            f"#1's wrapper launched {wrapper} times for {graphs} graphs, "
            f"expected {2 * graphs * per_forward}")
    record.update(graphs=graphs, replays=replays, wrapper_launches=wrapper,
                  bf16_site_min_db=bf16_low, wall_s=wall)

    # the bf16 graph forwards against the eager forward of their batches
    device = next(model.parameters()).device
    low = float("inf")
    with torch.inference_mode():
        for batch, est, n in batches:  # the rows that hold a segment
            eager = pcm16(model(torch.from_numpy(batch).to(device),
                                per_utterance=True,
                                compute_dtype=torch.bfloat16)).cpu().numpy()
            low = min(low, _snr(eager[:n].reshape(-1, eager.shape[-1]),
                                est[:n].reshape(-1, est.shape[-1])))
    record["bf16_graph_vs_eager_db"] = low
    _expect(low >= 60.0, f"bf16 graph vs eager: {low:.2f} dB")
    record["bf16_int16_vs_fp32_db"] = min(
        _snr(np.clip(m, -1, 1), p.astype(np.float64) / 32767.0)
        for m, p in zip(multi_out, pcm))
    print(f"  streaming vs stitch_segments {record['stream_vs_stitch_db']:.2f}"
          f" dB; multistream vs streaming {record['multi_vs_single_db']:.2f}"
          f" dB; bf16 int16: graph vs eager {low:.2f} dB, vs the fp32 "
          f"streams {record['bf16_int16_vs_fp32_db']:.2f} dB; async vs "
          f"separate_batched {record['async_vs_batched_db']:.2f} dB; 1 ms "
          f"deadline: {shed} shed, {len(served)} served; close: "
          f"{record['close_served']} of {len(futs)} served before it")
    print(f"  #1: {graphs} graphs x 2 x {per_forward} = {wrapper} wrapper "
          f"launches (set-up and capture); {replays} replays x "
          f"{per_forward} device launches; profiled window: {window} "
          f"replays, {dw_kernels} device kernels; {wall:.2f} s")
    return record


def time_serve(card, model, iters=30, n_requests=240):
    """Phase 21 on ``model``: the serving engines' times, every site #1
    is called at among those phase 20 checked (:func:`serve_combos`), every
    request answered. Returns the record; every line printed names
    ``card``."""
    with recorded_sites() as seen:
        out = _time_serve(card, model, iters, n_requests)
    expect_checked(seen, serve_sites(model, serve_combos(model)),
                   "serving times")
    return out


def _time_serve(card, model, iters, n_requests):
    out = {"card": card, "hops": [], "async": []}
    for n in (1, 4, 8):
        graph, eager, _ = hop_latency(model, n, iters)
        out["hops"].append({"streams": n, "graph": graph, "eager": eager})
        print(f"  MultiStream {n} streams, 1 s / 750 ms hops, bf16, int16: "
              f"p50/p90/p99 {graph['p50_ms']:.2f} / {graph['p90_ms']:.2f} / "
              f"{graph['p99_ms']:.2f} ms per hop; eager "
              f"{eager['p50_ms']:.2f} / {eager['p90_ms']:.2f} / "
              f"{eager['p99_ms']:.2f} ({card})")
    clips = bench.make_clips(SR, 32, 2.0)
    mean_s = float(np.mean([c.shape[-1] / SR for c in clips]))
    for dtype in (None, torch.bfloat16):
        for adaptive in (False, True):
            mb = 24 if adaptive else 8
            server = AsyncBatchServer(model, max_batch=mb,
                                      adaptive=adaptive,
                                      compute_dtype=dtype)
            try:
                bench.prewarm(server, clips)
                row = {"dtype": "bf16" if dtype else "fp32",
                       "ladder": server._ladder,
                       "pool_mib": server.pool_bytes() / 2 ** 20,
                       "forward": bench.forward_ab(server, 2 * SR, mb)}
                row["closed"] = bench.check(bench.closed_loop(
                    server, clips, 4 * mb, n_requests, SR))
                sat = row["closed"]["agg_rtfx"] / mean_s
                row["open"] = [bench.check(bench.open_loop(
                    server, clips, f * sat,
                    min(n_requests, max(60, int(f * sat * 2))), SR))
                    for f in (0.5, 0.9)]
                if not adaptive and dtype is None:
                    row["lone_b8"] = _lone(server, clips[0])
                if adaptive and dtype is torch.bfloat16:
                    busy, _, kernels, dev_ms, wall = profile_window(
                        lambda: bench.closed_loop(server, clips, 4 * mb,
                                                  96, SR))
                    bench.check(busy)
                    out["busy"] = {"kernels": kernels, "device_ms": dev_ms,
                                   "wall_ms": wall,
                                   "share": dev_ms / wall}
                row["stats"] = dict(server.stats)
            finally:
                server.close()
            out["async"].append(row)
            c, f = row["closed"], row["forward"]
            print(f"  AsyncBatchServer {row['dtype']} ladder "
                  f"{row['ladder']}: closed loop {c['agg_rtfx']:.1f}x "
                  f"realtime (p50 {c['p50_ms']:.1f} ms, p95 "
                  f"{c['p95_ms']:.1f}); open loop at 50% / 90%: p50 "
                  + " / ".join(f"{o['p50_ms']:.1f}" for o in row["open"])
                  + ", p95 " + " / ".join(f"{o['p95_ms']:.1f}"
                                          for o in row["open"])
                  + f" ms; forward B={f['B']} eager {f['eager_ms']:.2f} ms,"
                  f" graph {f['graph_ms']:.2f}; graph pool "
                  f"{row['pool_mib']:.0f} MiB after prewarm ({card})")
    lone = AsyncBatchServer(model, max_batch=8, adaptive=True, min_batch=1)
    try:
        lone.prewarm(lengths=[2 * SR], rungs=[1])
        out["lone_b1"] = _lone(lone, clips[0])
    finally:
        lone.close()
    b8 = out["async"][0]["lone_b8"]
    print(f"  a lone 2 s request: p50 {out['lone_b1']['p50_ms']:.2f} ms, "
          f"p90 {out['lone_b1']['p90_ms']:.2f} through a B=1 graph; p50 "
          f"{b8['p50_ms']:.2f} through the fixed server's B=8 ({card})")
    if "busy" in out:
        b = out["busy"]
        print(f"  profiled closed loop (bf16, ladder to 24, 96 requests): "
              f"device busy {100 * b['share']:.0f}% ({b['device_ms']:.1f} "
              f"of {b['wall_ms']:.1f} ms, {b['kernels']} device events)")
    return out


def _lone(server, clip, n=30):
    """Latency of ``n`` requests sent one at a time (the server idle)."""
    lat = []
    for _ in range(n + 2):
        t0 = time.perf_counter()
        server.separate(clip, timeout=60)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = lat[2:]
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90)),
            "min_ms": float(min(lat))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    model = bench.build(SR)
    record = {"card": card, "serve": drive_serve(model),
              "times": time_serve(card, model)}
    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
