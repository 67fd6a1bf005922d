"""Measurement on the card, shared by ``chip_smoke.py`` and the probes:
CUDA-event timers, a profiled window, the card's name and power limit,
and SNR."""

from __future__ import annotations

import contextlib
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


# Idle host seconds at each end of a profiled window. The profiler keeps
# only the device activity that its clock places inside the window, and
# the device's timestamps, converted to the host's clock, can put the
# first or last kernels of work that starts or ends at the window's edge
# outside it (ROADMAP C #8: 2 ms early in one window of 30 of a fresh
# process; more than 50 ms early late in chip_smoke.py's process, where
# windows padded by 50 ms lost the first kernels of their work, #1's
# among them; on an NVIDIA H100 80GB HBM3, 700.00 W).
WINDOW_PAD_S = 0.3


# Late in chip_smoke.py's process, windows padded on the host still lost
# a run of the first device kernels of their work (up to about 40: #1's
# first sites among them). So the device work inside a window is framed
# by sentinel kernels, ``torch.cuda._sleep``'s spin kernel, which a lost
# run at either edge takes first; the window's results leave them out.
SENTINEL = "spin_kernel"
SENTINEL_KERNELS, SENTINEL_CYCLES = 64, 4_000_000  # the last: about 2 ms


def _sentinels():
    for _ in range(SENTINEL_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda._sleep(SENTINEL_CYCLES)


class _Window:
    """A profiler's results without the window's sentinel kernels."""

    def __init__(self, prof):
        self.prof = prof

    def key_averages(self):
        return [e for e in self.prof.key_averages()
                if SENTINEL not in e.key]

    def events(self):
        return [e for e in self.prof.events() if SENTINEL not in e.name]


@contextlib.contextmanager
def profiled(pad_s=WINDOW_PAD_S):
    """A profiler window (CPU and CUDA activity) whose work inside starts
    ``pad_s`` after the window opens, after sentinel kernels on the
    device, and which closes ``pad_s`` after the device has finished it
    and sentinels behind it. Yields the profiler's results without the
    sentinels (``key_averages`` and ``events``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        _sentinels()
        yield _Window(prof)
        _sentinels()
        torch.cuda.synchronize()
        time.sleep(pad_s)


def _device_rows(prof):
    """A profiled window's ``key_averages`` rows on CUDA, and the names of
    its ``record_function`` marks."""
    marks = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA], marks


def device_kernels(prof):
    """A profiled window's device kernels by name (``key_averages`` rows
    on CUDA), without the ranges of ``record_function`` marks, which the
    profiler also reports on the device's timeline: torch.optim wraps every
    ``step()`` in one ("Optimizer.step#Adam.step"), and its span is not a
    kernel."""
    rows, marks = _device_rows(prof)
    return [e for e in rows if e.key not in marks]


def device_ranges(prof):
    """The rows that :func:`device_kernels` leaves out: the marks' ranges
    on the device's timeline."""
    rows, marks = _device_rows(prof)
    return [e for e in rows if e.key in marks]


def profile_window(fn):
    """Run ``fn`` under the profiler: (its return, #1's device kernels,
    all device events' count and ms, the wall ms)."""
    with profiled() as prof:
        t0 = time.perf_counter()
        ret = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_kernels(prof)
    dw = sum(e.count for e in events if "dw_conv_glob_ln" in e.key)
    return (ret, dw, sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3, wall)


def counted_windows(read, what, first=None):
    """Profiled windows until one holds exactly the #1 device kernels it
    should: ``read()`` profiles one window and returns (#1 kernels
    counted, kernels expected, record); ``first``, a window already read.
    A window can only lose events (ROADMAP C #8; :func:`profiled` pads
    its ends against the known cause), so a short window is read again
    once; a second short window, or a count above the expected one,
    fails. Every window's count is printed.
    Returns the matching window's record."""
    counts, got = [], first if first is not None else read()
    while True:
        n, want, record = got
        counts.append(n)
        if n == want or n > want or len(counts) == 2:
            break
        got = read()
    print(f"  {what}: #1 device kernels a profiled window {counts} "
          f"(expected {want})")
    if n != want:
        raise AssertionError(f"{what}: #1 device kernels {counts} in "
                             f"{len(counts)} profiled windows, expected "
                             f"{want}")
    return record


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
