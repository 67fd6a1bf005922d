"""The backward of kernel #1 (``dw_conv_glob_ln_backward``) at the training
recipe's depthwise sites: each against its plain version, and its time
beside the plain version's and the least time the card could take.

    python -m tdanet_tpu_torch.probes.dw_backward [--check-only | --no-check]
        [--no-plain] [--rows] [--out record.json]

Every time is device time from CUDA-graph replay. For each of the 14
site shapes a step runs, a row gives the kernel's us, its rate over the
bytes it must move (GB/s), its share of the bound and the planned share
of tiles staged a second time in phase 2 (those that do not stay in
shared memory, from the library's plan: whether the L2 or device memory
serves them is not measured; "n/a" on a tree whose wrapper has no
``backward_plan``). ``--rows`` times instead, at each stride-1 site shape
of the step, the instance of 8 rows a thread against that of 16 (8, 16,
16, 8). ``--no-check --no-plain`` times an older tree: unpack its
``tdanet_tpu_torch`` under ``build/``, copy this file into its
``probes/`` and run it there.

The recipe is ``configs/tdanet.yml``: TDANetBest out 128, in 512, depth 5,
4 ms encoder, 8 kHz, 3 s segments, batch 8, bf16 activations over fp32
parameters. Its block has the 20 site shapes of :data:`VARIANTS` x the
five scale lengths of :func:`recipe_scales`. Checks: bf16 activations
with fp32 parameters at B 8 (SNR of every gradient against the plain
backward run in fp32 on the same bf16-rounded values), fp32 at B 2 (max
abs of every gradient against plain, over the largest abs of plain); a
rerun equal bit for bit, and a CUDA-graph replay equal to the eager call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln_backward, dw_conv_glob_ln_backward_reference,
    forward_with_stats)
from tdanet_tpu_torch.probes.dw_sites import C, VARIANTS, scale_lengths
from tdanet_tpu_torch.utils.timing import (
    bound_ms, card_line, graph_time, snr_db)

GRADS = ("dx", "dweight", "dbias", "dgamma", "dbeta")
FP32_LIMIT = 1e-4   # max abs off plain over the largest abs of plain
BF16_LIMIT = 40.0   # dB against plain in fp32 on the bf16-rounded values


def recipe_scales(seconds=3.0, sample_rate=8000, enc_ms=4, depth=5):
    """The pyramid's lengths for one training segment: the encoder's
    frames of the lattice-padded wav (``ops.pad_signal``, a Conv1d of
    kernel K = enc_ms * sr / 1000, stride K / 4, padding K / 2), then each
    stride-2 k5 'same' output."""
    K = enc_ms * sample_rate // 1000
    S = K // 4
    T = int(seconds * sample_rate)
    rest = K - (S + T % K) % K
    padded = T + rest + 2 * (K - S)
    return scale_lengths((padded + 2 * (K // 2) - K) // S + 1, depth)


def operands(B, T, K, stride, bias, gen, dtype, C=C):
    """x as the model passes it ((B, C, T) seen as (B, T, C)) in ``dtype``,
    fp32 parameters, and dy in the output's layout."""
    x = torch.randn(B, C, T, generator=gen).to(dtype).cuda().transpose(1, 2)
    w = (torch.randn(C, 1, K, generator=gen) * 0.2).cuda()
    b = (torch.randn(C, generator=gen) * 0.1).cuda() if bias else None
    g = torch.randn(C, generator=gen).cuda()
    be = torch.randn(C, generator=gen).cuda()
    T_out = (T - 1) // stride + 1
    dy = torch.randn(B, C, T_out, generator=gen).to(dtype).cuda() \
        .transpose(1, 2)
    return x, w, b, g, be, dy


def check_site(B, T, K, stride, bias, gen, dtype, C=C, eps=1e-8):
    """One site of C channels and the norm's ``eps``: the kernel against
    plain (plain with its own one-pass statistics), a rerun and a graph
    replay. Returns ({grad: fp32 max abs error over plain's max abs, or
    bf16 SNR}, the largest abs error)."""
    x, w, b, g, be, dy = operands(B, T, K, stride, bias, gen, dtype, C)
    kw = dict(stride=stride, K=K)
    with torch.no_grad():
        _, stats = forward_with_stats(x, w, b, g, be, eps=eps, **kw)
        call = (lambda: dw_conv_glob_ln_backward(dy, x, w, b, g, stats,
                                                 **kw))
        got, again = call(), call()
        ref = dw_conv_glob_ln_backward_reference(
            dy.float(), x.float(), w, b, g, eps=eps, **kw)
        if got[0].stride() != x.stride() or got[0].dtype != x.dtype:
            raise AssertionError(f"dx {got[0].stride()} {got[0].dtype} for "
                                 f"x {x.stride()} {x.dtype}")
        result, max_abs = {}, 0.0
        for name, a, r in zip(GRADS, got, ref):
            if r is None:
                continue
            if dtype is torch.float32:
                err = (a - r).abs().max().item()
                max_abs = max(max_abs, err)
                result[name] = err / r.abs().max().item()
                ok = result[name] <= FP32_LIMIT
            else:
                result[name] = snr_db(r, a)
                ok = result[name] >= BF16_LIMIT
            if not ok:
                raise AssertionError(
                    f"backward {name} at B={B} T={T} K={K} s={stride} "
                    f"bias={bias} {dtype}: {result[name]}")
        if not all(a is None or torch.equal(a, c) for a, c in zip(got,
                                                                  again)):
            raise AssertionError("a second backward run differs")
        graph_equals_eager(call, got)
    return result, max_abs


def graph_equals_eager(call, eager):
    """The call captured in a CUDA graph: its replay must give ``eager``
    bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    if not all(a is None or torch.equal(a, c) for a, c in zip(out, eager)):
        raise AssertionError("backward graph replay differs from eager")


def sites():
    """(T, K, stride, bias) of the 20 site shapes of the recipe's block."""
    return [(T, K, s, bias) for T in recipe_scales()
            for K, s, bias in VARIANTS]


def check_all(gen):
    """Every site shape, bf16 activations at B 8 and fp32 at B 2. Returns
    the worst fp32 error over max abs, the largest fp32 abs error and the
    lowest bf16 SNR."""
    worst, worst_abs, low = 0.0, 0.0, float("inf")
    for T, K, s, bias in sites():
        r32, abs32 = check_site(2, T, K, s, bias, gen, torch.float32)
        r16, _ = check_site(8, T, K, s, bias, gen, torch.bfloat16)
        worst = max(worst, max(r32.values()))
        worst_abs = max(worst_abs, abs32)
        low = min(low, min(r16.values()))
        print(f"backward T={T:4d} K={K} s={s} bias={bias!s:5}: fp32 B=2 "
              f"max|d|/max|ref| {max(r32.values()):.2e} (limit "
              f"{FP32_LIMIT:g}), bf16 B=8 lowest SNR {min(r16.values()):.1f}"
              f" dB (limit {BF16_LIMIT:g}); rerun and graph replay equal",
              flush=True)
    torch.cuda.synchronize()
    return worst, worst_abs, low


def site_bound(B, T, K, stride, bias, elem):
    """(ms, "bytes" or "operations", bytes): x and dy read once, dx
    written once, the parameters and their gradients (fp32) once; about
    4K + 14 fp32 operations an output element (the conv recomputed, the
    two sums, dz, the four parameter sums, the transposed conv)."""
    T_out = (T - 1) // stride + 1
    n_bytes = B * C * (2 * T + T_out) * elem + 2 * C * (K + 3 + bias) * 4
    ms, by = bound_ms(n_bytes, (4.0 * K + 14) * B * T_out * C)
    return ms, by, n_bytes


def planned_restaged(B, T, K, stride, t_contig, elem):
    """The share of a launch's tiles that the library's plan stages a
    second time in phase 2 (each CTA's tiles past those it keeps in
    shared memory); None where the wrapper has no ``backward_plan``."""
    plan_of = getattr(dw, "backward_plan", None)
    if plan_of is None:
        return None
    T_out = (T - 1) // stride + 1
    bp = plan_of(int(elem == 2), K, stride, t_contig,
                 dw.backward_rows(T_out, stride, t_contig), B, T_out, C,
                 torch.cuda.current_device())
    return 1 - bp.kept / bp.n_tiles


def time_site(B, T, K, stride, bias, gen, dtype, plain=True):
    """Device ms of the kernel and of the plain backward (CUDA-graph
    replay) and the bound at one site shape. Returns a row."""
    x, w, b, g, be, dy = operands(B, T, K, stride, bias, gen, dtype)
    kw = dict(stride=stride, K=K)
    with torch.no_grad():
        _, stats = forward_with_stats(x, w, b, g, be, **kw)
        kern = graph_time(lambda: dw_conv_glob_ln_backward(
            dy, x, w, b, g, stats, **kw), reps=20)
        pms = graph_time(lambda: dw_conv_glob_ln_backward_reference(
            dy, x, w, b, g, stats=stats, **kw), reps=20)[0] if plain \
            else None
    bms, by, n_bytes = site_bound(B, T, K, stride, bias,
                                  x.element_size())
    again = planned_restaged(B, T, K, stride, True, x.element_size())
    row = dict(B=B, T=T, K=K, stride=stride, bias=bias,
               dtype=str(dtype)[6:], ms=kern[0], plain_ms=pms,
               bound_ms=bms, bound_by=by, bytes=n_bytes,
               gb_s=n_bytes / kern[0] / 1e6, planned_restaged=again)
    print(f"backward B={B} T={T} K={K} s={stride} bias={bias!s:5} "
          f"{row['dtype']}: kernel {kern[0] * 1e3:.2f} us "
          f"({row['gb_s']:.0f} GB/s), plain "
          + ("-" if pms is None else f"{pms * 1e3:.2f}")
          + f" us, bound {bms * 1e3:.2f} us ({by}: {n_bytes / 1e6:.2f} MB),"
          f" {100 * bms / kern[0]:.0f}% of it; tiles staged twice "
          "(planned): " + ("n/a" if again is None else f"{100 * again:.1f}%")
          + f" [{card_line()}]", flush=True)
    return row


def step_sites(depth=5, num_blocks=16):
    """(T, K, stride, bias) of every backward launch of one training
    step: a block's depthwise sites (``dw_sites.block_sites``) but the
    coarsest scale's LA fusion, whose 3 sites never reach the loss (the
    expansion reads the finer scales), times the iterations: 464."""
    from tdanet_tpu_torch.probes.dw_sites import block_sites
    sites = block_sites(recipe_scales(depth=depth)[0], depth)
    dead = depth + 3 * (depth - 1)  # the coarsest fusion's first site
    return (sites[:dead] + sites[dead + 3:]) * num_blocks


def time_all(gen, plain=True):
    """The finest K5 stride-1 site at B 8 bf16 and B 2 fp32, then each of
    the 14 site shapes a step runs at B 8 bf16, summed over the step's 464
    launches. Returns (finest rows, step sums {ms, plain_ms, bound_ms},
    the 14 rows)."""
    T0 = recipe_scales()[0]
    finest = [time_site(8, T0, 5, 1, True, gen, torch.bfloat16, plain),
              time_site(2, T0, 5, 1, True, gen, torch.float32, plain)]
    rows = {}
    for T, K, s, bias in sorted(set(step_sites()), reverse=True):
        rows[(T, K, s, bias)] = time_site(8, T, K, s, bias, gen,
                                          torch.bfloat16, plain)
    keys = ("ms", "plain_ms", "bound_ms") if plain else ("ms", "bound_ms")
    sums = {k: sum(rows[site][k] for site in step_sites()) for k in keys}
    print(f"one step's {len(step_sites())} backward launches at B=8 bf16, "
          f"summed: kernel {sums['ms']:.3f} ms, "
          + (f"plain {sums['plain_ms']:.3f} ms, " if plain else "")
          + f"bound {sums['bound_ms']:.3f} ms [{card_line()}]")
    return finest, sums, list(rows.values())


def compare_rows(gen):
    """At each stride-1 site shape of a step (B 8 bf16, T innermost), the
    instance of 8 rows a thread against that of 16, timed in turns (8,
    16, 16, 8), and each summed over the step's launches of those shapes.
    Returns the rows: (T, K, bias, us of 8, us of 16, the wrapper's
    choice)."""
    shapes = sorted({site for site in step_sites() if site[2] == 1},
                    reverse=True)
    out = []
    for T, K, _, bias in shapes:
        x, w, b, g, be, dy = operands(8, T, K, 1, bias, gen, torch.bfloat16)
        with torch.no_grad():
            _, stats = forward_with_stats(x, w, b, g, be, stride=1, K=K)
            times = {8: [], 16: []}
            for rows in (8, 16, 16, 8):
                times[rows].append(graph_time(
                    lambda: dw._launch_backward(dy, x, w, b, g, stats, 1, K,
                                                rows), reps=20)[0])
        us8, us16 = (1e3 * min(times[r]) for r in (8, 16))
        pick = dw.backward_rows(T, 1, True)
        out.append(dict(T=T, K=K, bias=bias, us8=us8, us16=us16, pick=pick,
                        us8_runs=[1e3 * t for t in times[8]],
                        us16_runs=[1e3 * t for t in times[16]]))
        print(f"rows a thread, B=8 T={T} K={K} s=1 bias={bias!s:5} bf16: "
              f"8 rows {us8:.2f} us, 16 rows {us16:.2f} us (each the "
              f"lower of two; the wrapper takes {pick}) [{card_line()}]",
              flush=True)
    n = {site: step_sites().count(site) for site in
         ((r["T"], r["K"], 1, r["bias"]) for r in out)}
    for key in ("us8", "us16"):
        total = sum(r[key] * n[(r["T"], r["K"], 1, r["bias"])] for r in out)
        print(f"one step's {sum(n.values())} stride-1 launches with "
              f"{key[2:]} rows a thread: {total / 1e3:.3f} ms")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-plain", action="store_true")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    gen = torch.Generator().manual_seed(0)
    record = {"card": card_line()}
    if args.rows:
        record["rows"] = compare_rows(gen)
    elif not args.no_check:
        worst, worst_abs, low = check_all(gen)
        record.update(fp32_worst=worst, fp32_max_abs=worst_abs,
                      bf16_lowest_db=low)
    if not (args.check_only or args.rows):
        record["finest"], record["step"], record["sites"] = time_all(
            gen, plain=not args.no_plain)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
