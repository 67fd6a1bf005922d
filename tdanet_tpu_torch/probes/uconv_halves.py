"""The two UConvBlock-half kernels alone on the card: each against its plain
version, a rerun, a CUDA-graph replay, their time and their device kernels.

    python -m tdanet_tpu_torch.probes.uconv_halves [--out FILE]

At the bench model's full width (T 2010, C_out 128, C 512, depth 5) with
seeded weights, for B 1 and 4 in fp32 (TF32 off) and B 24 in bf16, the
probe checks pyramid_fused and fuse_expand_fused against their plain
versions, then prints for each: device us per call replayed from a CUDA
graph and eager, the plain version's, the device kernels one call launches
and a per-launch profile (torch.profiler), under the card's name and power
limit. It uses only the wrappers' public functions, so a copy of it times
an older tree the same way.
"""

from __future__ import annotations

import argparse
import json

import torch

from tdanet_tpu_torch.kernels.uconv_block import (
    fuse_expand_fused, fuse_expand_fused_reference, pyramid_fused,
    pyramid_fused_reference, scale_lengths, to_raw)
from tdanet_tpu_torch.probes.uconv_kernel import C, COUT, DEPTH, T, seeded_block
from tdanet_tpu_torch.utils.timing import (
    card_line, cuda_time, graph_time, snr_db)

CASES = ((1, torch.float32), (4, torch.float32), (24, torch.bfloat16))
NAMES = ("pyramid_fused", "fuse_expand_fused")


def half_inputs(B, dtype, seed, T0=T, depth=DEPTH):
    """A seeded full-width block on the card, its padded input, and the
    plain pyramid's outputs with a post-GA global feature (the operands of
    both halves), in ``dtype``. g keeps GA's layout: a (B, T_g, C) view of
    a (B, C, T_g) tensor."""
    gen = torch.Generator().manual_seed(seed)
    block = seeded_block(COUT, C, depth, seed).cuda()
    x_raw = to_raw(torch.randn(B, COUT, T0, generator=gen).cuda().to(dtype))
    with torch.inference_mode():
        scales, pooled = pyramid_fused_reference(
            x_raw.float(), block, depth=depth, raw=True, raw_in=True, T0=T0)
        Tg = scale_lengths(T0, depth)[-1]
        g = block.globalatt(pooled[:, :Tg].transpose(1, 2)).transpose(1, 2)
    return block, x_raw, [s.to(dtype) for s in scales], g.to(dtype)


def calls(block, x_raw, scales, g, T0, depth=DEPTH):
    """{name: (kernel call, plain call)} on these operands; the plain
    versions run in fp32 on the same values."""
    Ts = scale_lengths(T0, depth)
    return {
        "pyramid_fused": (
            lambda: pyramid_fused(x_raw, block, depth=depth, raw=True,
                                  raw_in=True, T0=T0),
            lambda: pyramid_fused_reference(
                x_raw.float(), block, depth=depth, raw=True, raw_in=True,
                T0=T0)),
        "fuse_expand_fused": (
            lambda: fuse_expand_fused(scales, g, x_raw, block, Ts=Ts),
            lambda: fuse_expand_fused_reference(
                [s.float() for s in scales], g.float(), x_raw.float(), block,
                Ts=Ts))}


def _outputs(result):
    """A half's outputs as a flat list."""
    if isinstance(result, torch.Tensor):
        return [result]
    scales, pooled = result
    return list(scales) + [pooled]


def check(B, dtype, seed, T0=T, depth=DEPTH):
    """Both kernels against their plain versions, every output with its pad
    rows: fp32 max |d| <= 2e-3 max |ref|, bf16 SNR >= 30 dB; a second run
    equal bit for bit; one call captured in a CUDA graph, replayed, equal
    to the eager call bit for bit. Returns {name: worst fp32 max |d| or
    lowest bf16 SNR}."""
    block, x_raw, scales, g = half_inputs(B, dtype, seed, T0, depth)
    worst = {}
    with torch.inference_mode():
        for name, (kern, plain) in calls(block, x_raw, scales, g, T0,
                                         depth).items():
            got, again = _outputs(kern()), _outputs(kern())
            ref = _outputs(plain())
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                kern()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = _outputs(kern())
            graph.replay()
            torch.cuda.synchronize()
            marks = []
            for i, (a, b) in enumerate(zip(got, ref)):
                if a.shape != b.shape or a.dtype != dtype:
                    raise AssertionError(f"{name} output {i}: {a.shape} "
                                         f"{a.dtype}, want {b.shape}")
                if dtype == torch.float32:
                    err = (a - b).abs().max().item()
                    lim = 2e-3 * b.abs().max().item()
                    ok, mark = err <= lim, err
                    what = f"max|d|={err:.3e} (limit {lim:.3e})"
                else:
                    snr = snr_db(b, a)
                    ok, mark, what = snr >= 30.0, -snr, \
                        f"SNR={snr:.1f} dB (limit 30)"
                print(f"{name} B={B} T={T0} depth={depth} {str(dtype)[6:]} "
                      f"output {i} {tuple(a.shape)}: {what}")
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         "version")
                marks.append(mark)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: a second run differs")
            if not all(torch.equal(a, b) for a, b in zip(got, captured)):
                raise AssertionError(f"{name}: graph replay differs from "
                                     "the eager call")
            print(f"{name} B={B} T={T0} {str(dtype)[6:]}: rerun equal bit "
                  f"for bit, graph replay equal to eager")
            worst[name] = max(marks) if dtype == torch.float32 else \
                -max(marks)
    return worst


def profile_call(fn, n=10):
    """Device kernels of n calls: (kernels per call, [(name, launches per
    call, device us per call)], memsets per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key, e.count / n, e.self_device_time_total / n)
                   for e in events), key=lambda r: -r[2])
    kernels = sum(c for k, c, _ in rows if "emset" not in k)
    memsets = sum(c for k, c, _ in rows if "emset" in k)
    return kernels, rows, memsets


def time_case(B, dtype, seed=1):
    """Each half at (B, dtype): {name: {us, eager_us, plain_us, kernels,
    memsets, profile}}; device time from CUDA-graph replay."""
    block, x_raw, scales, g = half_inputs(B, dtype, seed)
    out = {}
    with torch.inference_mode():
        for name, (kern, plain) in calls(block, x_raw, scales, g, T).items():
            kg, pg = graph_time(kern), graph_time(plain, reps=10)
            ke = cuda_time(kern, reps=20)
            kernels, rows, memsets = profile_call(kern)
            out[name] = {"us": kg[0] * 1e3, "eager_us": ke[0] * 1e3,
                         "plain_us": pg[0] * 1e3, "kernels": kernels,
                         "memsets": memsets,
                         "profile": [list(r) for r in rows]}
            print(f"{name} B={B} {str(dtype)[6:]}: device (graph replay) "
                  f"{kg[0] * 1e3:.1f} us, eager {ke[0] * 1e3:.1f} us, plain "
                  f"{pg[0] * 1e3:.1f} us; {kernels:g} device kernels and "
                  f"{memsets:g} memsets per call", flush=True)
            for key, count, us in rows:
                print(f"    {us:9.2f} us {count:5.2f}x {key[:90]}")
    torch.cuda.synchronize()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results as JSON here")
    ap.add_argument("--no-check", action="store_true",
                    help="time only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; T={T} C_out={COUT} C={C} depth={DEPTH}",
          flush=True)
    if not args.no_check:
        for B, dtype in CASES:
            check(B, dtype, seed=B)
    results = {"card": card, "cases": {}}
    for B, dtype in CASES:
        results["cases"][f"B{B}_{str(dtype)[6:]}"] = time_case(B, dtype)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
