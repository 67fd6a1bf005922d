"""The backward of kernel #1 (``dw_conv_glob_ln_backward``) at the training
recipe's depthwise sites: each against its plain version, and its time
beside the plain version's and the least time the card could take.

    python -m tdanet_tpu_torch.probes.dw_backward [--check-only]
        [--out record.json]

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


def operands(B, T, K, stride, bias, gen, dtype):
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


def check_site(B, T, K, stride, bias, gen, dtype):
    """One site: the kernel against plain (plain with its own one-pass
    statistics), a rerun and a graph replay. Returns ({grad: fp32 max abs
    error over plain's max abs, or bf16 SNR}, the largest abs error)."""
    x, w, b, g, be, dy = operands(B, T, K, stride, bias, gen, dtype)
    kw = dict(stride=stride, K=K)
    with torch.no_grad():
        _, stats = forward_with_stats(x, w, b, g, be, **kw)
        call = (lambda: dw_conv_glob_ln_backward(dy, x, w, b, g, stats,
                                                 **kw))
        got, again = call(), call()
        ref = dw_conv_glob_ln_backward_reference(
            dy.float(), x.float(), w, b, g, **kw)
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


def time_site(B, T, K, stride, bias, gen, dtype):
    """Device ms of the kernel and of the plain backward (CUDA-graph
    replay) and the bound at one site shape. Returns a row."""
    x, w, b, g, be, dy = operands(B, T, K, stride, bias, gen, dtype)
    kw = dict(stride=stride, K=K)
    with torch.no_grad():
        _, stats = forward_with_stats(x, w, b, g, be, **kw)
        kern = graph_time(lambda: dw_conv_glob_ln_backward(
            dy, x, w, b, g, stats, **kw), reps=20)
        plain = graph_time(lambda: dw_conv_glob_ln_backward_reference(
            dy, x, w, b, g, stats=stats, **kw), reps=20)
    bms, by, n_bytes = site_bound(B, T, K, stride, bias,
                                  x.element_size())
    row = dict(B=B, T=T, K=K, stride=stride, bias=bias,
               dtype=str(dtype)[6:], ms=kern[0], plain_ms=plain[0],
               bound_ms=bms, bound_by=by, bytes=n_bytes)
    print(f"backward B={B} T={T} K={K} s={stride} bias={bias} "
          f"{row['dtype']}: kernel {kern[0] * 1e3:.2f} us, plain "
          f"{plain[0] * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by}: "
          f"{n_bytes / 1e6:.2f} MB), {100 * bms / kern[0]:.0f}% of it "
          f"[{card_line()}]", flush=True)
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


def time_all(gen):
    """The finest K5 stride-1 site at B 8 bf16 and B 2 fp32, then every
    site shape at B 8 bf16 summed over a step's 464 launches. Returns
    (finest rows, step sums {ms, plain_ms, bound_ms})."""
    T0 = recipe_scales()[0]
    finest = [time_site(8, T0, 5, 1, True, gen, torch.bfloat16),
              time_site(2, T0, 5, 1, True, gen, torch.float32)]
    rows = {}
    for T, K, s, bias in sorted(set(step_sites())):
        rows[(T, K, s, bias)] = time_site(8, T, K, s, bias, gen,
                                          torch.bfloat16)
    sums = {k: sum(rows[site][k] for site in step_sites())
            for k in ("ms", "plain_ms", "bound_ms")}
    print(f"one step's {len(step_sites())} backward launches at B=8 bf16, "
          f"summed: kernel {sums['ms']:.3f} ms, plain {sums['plain_ms']:.3f}"
          f" ms, bound {sums['bound_ms']:.3f} ms [{card_line()}]")
    return finest, sums


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    gen = torch.Generator().manual_seed(0)
    worst, worst_abs, low = check_all(gen)
    record = {"card": card_line(), "fp32_worst": worst,
              "fp32_max_abs": worst_abs, "bf16_lowest_db": low}
    if not args.check_only:
        record["finest"], record["step"] = time_all(gen)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
