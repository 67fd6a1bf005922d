"""Measurement on the card, shared by ``chip_smoke.py`` and the probes:
CUDA-event timers, a profiled window, the card's name and power limit,
and SNR."""

from __future__ import annotations

import math
import statistics
import subprocess
import time

import torch


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def snr_db(ref, est):
    """10 log10(|ref|^2 / |est - ref|^2), in float64."""
    ref = ref.double()
    err = est.double() - ref
    return 10 * math.log10(ref.square().sum().item()
                           / max(err.square().sum().item(), 1e-300))


def cuda_time(fn, reps, runs=7, warmup=3):
    """Median ms per call over ``runs`` runs of ``reps`` calls, the runs,
    and the runs more than twice the median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    med = statistics.median(times)
    return med, times, [t for t in times if t > 2 * med]


def graph_time(fn, reps=50, runs=7):
    """Device ms per call, host cost excluded: ``reps`` calls captured in
    one CUDA graph, whose replay cuda_time times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    med, times, flagged = cuda_time(graph.replay, reps=1, runs=runs)
    return med / reps, [t / reps for t in times], [t / reps for t in flagged]


def profile_window(fn):
    """Run ``fn`` under the profiler: (its return, #1's device kernels,
    all device events' count and ms, the wall ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ret = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    dw = sum(e.count for e in events if "dw_conv_glob_ln" in e.key)
    return (ret, dw, sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3, wall)


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense rates): device memory bytes/s, fp32 FLOP/s outside the tensor
# cores, bf16 FLOP/s on them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}


def nbytes(*tensors):
    """Bytes of the tensors' elements (a view counts what it shows)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes, flops=0.0, peak="fp32"):
    """The least ms the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the peak rate of their type. Returns (ms, "bytes"
    or "operations")."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")
