"""Kernel #1 (``dw_conv_glob_ln``) at the served forward's depthwise sites:
which shapes one forward runs, the least time the card could take for
each, and the kernel's time at each, against its plain version.

    python -m tdanet_tpu_torch.probes.dw_sites [--kernel-names a,b]
        [--out record.json]

The served model is TDANetBest at the bench's width (out 128, in 512, 16
blocks, depth 5, 4 ms encoder, 2 sources, 16 kHz) with seeded weights; a
2 s clip makes the finest scale (1, 512, 2010). Every time is device time
from CUDA-graph replay (B=1 fp32 at every site shape, B=4 fp32 and B=24
bf16 at the finest K5 stride-1 site), with eager time beside the kernel's;
the profiler then sums the device time of #1's kernels over one forward.
``--kernel-names`` lists the substrings that name #1's device kernels in
the profiler (default: ``dw_conv_glob_ln``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.utils.timing import (
    bound_ms, card_line, cuda_time, graph_time)

SERVED = dict(out_channels=128, in_channels=512, num_blocks=16,
              upsampling_depth=5, enc_kernel_size=4, num_sources=2,
              sample_rate=16000)
C = 512
SCALES = (2010, 1005, 503, 252, 126)  # a 2 s clip's chain, finest first
VARIANTS = (  # (K, stride, bias): the four kinds of depthwise ConvNorm
    (5, 1, True), (5, 2, True), (5, 1, False), (1, 1, False))


def scale_lengths(T0, depth):
    """The pyramid's lengths: T0, then each stride-2 k5 'same' output."""
    Ts = [T0]
    for _ in range(1, depth):
        Ts.append((Ts[-1] - 1) // 2 + 1)
    return Ts


def block_sites(T0, depth):
    """(input length, K, stride, bias) of every depthwise ConvNorm one
    UConvBlock calls, in its order: the pyramid (k5 with bias, stride 1
    then 2), the per-scale LA fusions (k1: local at the scale, act and
    embedding at the coarsest), the top-down expansions (k5: local at the
    scale, act and embedding at the g it is paired with: the finer scale
    depth-3 first, as the reference does, then the last expansion)."""
    Ts = scale_lengths(T0, depth)
    sites = [(T0, 5, 1, True)] + [(Ts[i - 1], 5, 2, True)
                                  for i in range(1, depth)]
    for Ti in Ts:
        sites += [(Ti, 1, 1, False)] + [(Ts[-1], 1, 1, False)] * 2
    for i in range(depth - 2, -1, -1):
        Tg = Ts[i - 1] if i == depth - 2 else Ts[i + 1]
        sites += [(Ts[i], 5, 1, False)] + [(Tg, 5, 1, False)] * 2
    return sites


def site_inputs(B, T, K, bias, gen, dtype=torch.float32):
    """Main-path operands on the card: the model's (B, C, T) activation
    seen as (B, T, C), and a depthwise ConvNorm's parameters, all in
    ``dtype``."""
    x = torch.randn(B, C, T, generator=gen).to(dtype).cuda().transpose(1, 2)
    w = (torch.randn(C, 1, K, generator=gen) * 0.2).to(dtype).cuda()
    b = (torch.randn(C, generator=gen) * 0.1).to(dtype).cuda() \
        if bias else None
    g = torch.randn(C, generator=gen).to(dtype).cuda()
    be = torch.randn(C, generator=gen).to(dtype).cuda()
    return x, w, b, g, be


def site_bound(B, T, K, stride, bias, elem=4):
    """(ms, "bytes" or "operations", bytes) of one site: x read once, out
    written once, the parameters read once; K multiply-adds an output and
    about six more operations for the statistics and the affine."""
    T_out = (T - 1) // stride + 1
    n_bytes = B * C * (T + T_out) * elem + C * (K + 2 + bias) * elem
    ms, by = bound_ms(n_bytes, (2.0 * K + 6) * B * T_out * C)
    return ms, by, n_bytes


def time_site(B, T, K, stride, bias, gen, dtype=torch.float32):
    """Kernel and plain ms on this site's shape: (kernel replayed, kernel
    eager, plain replayed, flags of runs over 2x their median)."""
    x, w, b, g, be = site_inputs(B, T, K, bias, gen, dtype)
    kw = dict(stride=stride, K=K)
    with torch.inference_mode():
        kern = graph_time(lambda: dw_conv_glob_ln(x, w, b, g, be, **kw))
        eager = cuda_time(lambda: dw_conv_glob_ln(x, w, b, g, be, **kw),
                          reps=50)
        plain = graph_time(
            lambda: dw_conv_glob_ln_reference(x, w, b, g, be, **kw))
    flags = [f for t in (kern, eager, plain) for f in t[2]]
    return kern[0], eager[0], plain[0], flags


def time_sites(gen):
    """Every site shape at B=1 fp32, then the finest K5 stride-1 site at
    B=4 fp32 and B=24 bf16. Returns rows of dicts, printing each."""
    cases = [(1, T, K, s, bias, torch.float32)
             for T in SCALES for K, s, bias in VARIANTS]
    cases += [(4, 2010, 5, 1, True, torch.float32),
              (24, 2010, 5, 1, True, torch.bfloat16)]
    rows = []
    for B, T, K, s, bias, dtype in cases:
        ms, eager, plain, flags = time_site(B, T, K, s, bias, gen, dtype)
        elem = torch.tensor([], dtype=dtype).element_size()
        bms, by, n_bytes = site_bound(B, T, K, s, bias, elem)
        row = dict(B=B, T=T, K=K, stride=s, bias=bias,
                   dtype=str(dtype)[6:], us=ms * 1e3, eager_us=eager * 1e3,
                   plain_us=plain * 1e3, bound_us=bms * 1e3, bound_by=by,
                   bytes=n_bytes)
        rows.append(row)
        print(f"dw_conv_glob_ln ({B}, {T}, {C}) {row['dtype']} K={K} "
              f"s={s} bias={bias!s:5}: us per call, device (graph replay) "
              f"{row['us']:.2f} (eager {row['eager_us']:.2f}), plain "
              f"{row['plain_us']:.2f}; bound {row['bound_us']:.2f} ({by}, "
              f"{n_bytes / 1e6:.2f} MB)"
              + (f"; runs over 2x median: {flags}" if flags else ""),
              flush=True)
    return rows


def forward_sums(rows, T0=2010, depth=5, blocks=16):
    """One forward's 512 sites summed from the B=1 fp32 rows: (kernel us,
    bound us, bytes, sites)."""
    by_shape = {(r["T"], r["K"], r["stride"], r["bias"]): r for r in rows
                if r["B"] == 1 and r["dtype"] == "float32"}
    sites = block_sites(T0, depth) * blocks
    us = sum(by_shape[s]["us"] for s in sites)
    bound = sum(by_shape[s]["bound_us"] for s in sites)
    n_bytes = sum(by_shape[s]["bytes"] for s in sites)
    return us, bound, n_bytes, len(sites)


def profile_forward(model, wav, names=("dw_conv_glob_ln",)):
    """Profile one forward. Returns a dict: #1's device kernels and ms
    (the device rows whose name holds one of ``names``), all device
    kernels and ms, the wall ms with the profiler on, the top rows."""
    import time
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(wav)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(wav)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    mine = [e for e in events if any(n in e.key for n in names)]
    dev = lambda e: e.self_device_time_total  # noqa: E731 (us)
    top = sorted(events, key=dev, reverse=True)[:8]
    return dict(dw_kernels=sum(e.count for e in mine),
                dw_ms=sum(dev(e) for e in mine) / 1e3,
                kernels=sum(e.count for e in events),
                device_ms=sum(dev(e) for e in events) / 1e3, wall_ms=wall,
                top=[(dev(e) / 1e3, e.count, e.key[:90]) for e in top])


def print_profile(prof):
    print(f"profiled forward: {prof['kernels']} device kernels, "
          f"{prof['device_ms']:.3f} ms device time in {prof['wall_ms']:.2f}"
          f" ms wall (profiler on); dw_conv_glob_ln {prof['dw_kernels']} "
          f"kernels, {prof['dw_ms']:.3f} ms")
    for ms, count, key in prof["top"]:
        print(f"  {ms:8.3f} ms {count:5d}x {key}")


def served_model(seed=1234):
    from tdanet_tpu_torch.models import TDANetBest
    model = TDANetBest(**SERVED)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.cuda().eval()


def report_forward(model, names):
    """Profile and replay one 2 s forward; print and return the numbers."""
    rng = np.random.default_rng(9)
    wav = torch.from_numpy(
        (0.1 * rng.standard_normal(32000)).astype(np.float32)).cuda()[None]
    prof = profile_forward(model, wav, names)
    print_profile(prof)
    with torch.inference_mode():
        gms, gruns, _ = graph_time(lambda: model(wav), reps=1, runs=9)
    print(f"forward B=1 2 s fp32 replayed from a CUDA graph: {gms:.3f} ms "
          f"(runs {[round(t, 3) for t in gruns]})")
    return dict(prof, replay_ms=gms, replay_runs=gruns)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-names", default="dw_conv_glob_ln")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: this probe runs only on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    rows = time_sites(torch.Generator().manual_seed(0))
    us, bound, n_bytes, n = forward_sums(rows)
    print(f"one forward's {n} sites from the B=1 rows: kernel {us:.1f} us, "
          f"bound {bound:.1f} us ({n_bytes / 1e6:.1f} MB)")
    fwd = report_forward(served_model(), tuple(args.kernel_names.split(",")))
    record = dict(card=card, rows=rows, forward_sites_us=us,
                  forward_bound_us=bound, forward_bytes=n_bytes, **fwd)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
