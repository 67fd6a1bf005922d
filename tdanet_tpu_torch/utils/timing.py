"""Measurement on the card, shared by ``chip_smoke.py`` and the probes:
CUDA-event timers, the card's name and power limit, and SNR."""

from __future__ import annotations

import math
import statistics
import subprocess

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
