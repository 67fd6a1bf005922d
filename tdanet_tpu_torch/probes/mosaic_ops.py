"""The micro-kernels of the UConvBlock's ops on the card, each against its
plain PyTorch version (counterpart of ``scripts/probe_mosaic_ops.py``).

    python -m tdanet_tpu_torch.probes.mosaic_ops [batch]

At the script's shape (B, R, C) = (24, 2032, 512) bf16 with 1008 decimated
rows, inputs from a seeded generator: copy, the five-tap FMA with fp32 and
with bf16 accumulation, the decimation product on fp32 and on bf16
operands, statistics + normalise, the projection product (128 -> 512) and
the x2 row repeat. Each variant is checked against its plain version, then
timed with CUDA events (median of 7 runs), replayed from a CUDA graph
(device time) and eager, beside the plain version, the one PyTorch call
that computes the same function where there is one, and the card's bound
for the variant's bytes and operations. Every line carries the card's name
and power limit.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tdanet_tpu_torch.kernels import micro_ops as mo
from tdanet_tpu_torch.utils.timing import (
    bound_ms, card_line, cuda_time, graph_time, nbytes, snr_db)

B, R, C = 24, 2032, 512
RD = 1008  # decimated rows
REPS = 10


@dataclass
class Variant:
    """One micro-kernel at one setting. ``rows`` is the slice of output
    rows the kernel computes (the rest must be zero); ``exact`` asks for
    equality with the plain version, else SNR >= 40 dB on those rows.
    ``library`` is the one PyTorch call that computes the same rows, timed
    beside the kernel and called nowhere else; None where no one call does
    (the chunked statistics, whose divisor is the script's own)."""
    name: str
    wrapper: Callable
    kernel: Callable
    plain: Callable
    inputs: tuple
    rows: slice
    flops: float = 0.0
    peak: str = "fp32"
    exact: bool = False
    library: Optional[Callable] = None


def inputs(batch=B, seed=0, device="cuda"):
    """The scripts' operands from one seeded generator: x bf16 (B, R, C),
    taps fp32 (8, C), the decimation matrix fp32 (RD, R), the projection
    weight bf16 (128, C)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, R, C, generator=gen).bfloat16().to(device)
    w = torch.randn(8, C, generator=gen).to(device)
    dec = torch.randn(RD, R, generator=gen).to(device)
    wp = torch.randn(mo.PROJ_K, C, generator=gen).bfloat16().to(device)
    return x, w, dec, wp


def taps_library(x, w, n):
    """The one PyTorch call that computes the five taps over n rows: a
    depthwise ``F.conv1d`` on the (B, C, rows) view of x, bf16 taps. Its
    output is (B, C, n), without the zero rows."""
    rows = x[:, 6:n + 10].transpose(1, 2)
    weight = w[:5].t().unsqueeze(1).to(x.dtype).contiguous()
    return lambda: F.conv1d(rows, weight, groups=x.shape[2])


def variants(x, w, dec, wp):
    """The first script's eight kernels."""
    n = x.shape[0]
    dec16 = dec.bfloat16()
    x128 = x[:, :, :mo.PROJ_K].contiguous()
    tap_flops = 2.0 * 5 * n * 2010 * C
    dec_flops = 2.0 * n * RD * R * C
    proj_flops = 2.0 * n * R * mo.PROJ_K * C
    return [
        Variant("copy", mo.copy, lambda: mo.copy(x),
                lambda: mo.copy_reference(x), (x,), slice(0, R), exact=True,
                library=x.clone),
        Variant("taps fp32 acc", mo.taps, lambda: mo.taps(x, w),
                lambda: mo.taps_reference(x, w), (x[:, 6:2020], w[:5]),
                slice(8, 2018), tap_flops,
                library=taps_library(x, w, 2010)),
        Variant("taps bf16 acc", mo.taps,
                lambda: mo.taps(x, w, acc=torch.bfloat16),
                lambda: mo.taps_reference(x, w, acc=torch.bfloat16),
                (x[:, 6:2020], w[:5]), slice(8, 2018), tap_flops,
                library=taps_library(x, w, 2010)),
        Variant("decimate fp32 operands", mo.decimate,
                lambda: mo.decimate(x, dec),
                lambda: mo.decimate_reference(x, dec), (x, dec),
                slice(0, RD), dec_flops, "fp32",
                library=lambda: torch.matmul(dec, x.float())),
        Variant("decimate bf16 operands", mo.decimate,
                lambda: mo.decimate(x, dec16),
                lambda: mo.decimate_reference(x, dec16), (x, dec16),
                slice(0, RD), dec_flops, "bf16",
                library=lambda: torch.matmul(dec16, x)),
        Variant("stats + normalise", mo.stats_normalize,
                lambda: mo.stats_normalize(x),
                lambda: mo.stats_normalize_reference(x), (x,), slice(0, R),
                5.0 * x.numel(),
                library=lambda: F.layer_norm(x, (R, C), eps=1e-8)),
        Variant("proj (128 -> 512)", mo.proj, lambda: mo.proj(x128, wp),
                lambda: mo.proj_reference(x128, wp), (x128, wp),
                slice(0, R), proj_flops, "bf16",
                library=lambda: torch.matmul(x128, wp)),
        Variant("repeat x2 (1005 -> 2010)", mo.repeat2,
                lambda: mo.repeat2(x), lambda: mo.repeat2_reference(x),
                (x[:, :1005],), slice(0, 2010), exact=True,
                library=lambda: torch.repeat_interleave(x[:, :1005], 2,
                                                        dim=1)),
    ]


def check(v: Variant):
    """The kernel against its plain version: equality or SNR >= 40 dB on
    the computed rows, zeros on every other row. Returns the max abs
    difference."""
    got, want = v.kernel(), v.plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{v.name}: {got.shape} {got.dtype}")
    rest = torch.ones(got.shape[1], dtype=torch.bool, device=got.device)
    rest[v.rows] = False
    if got[:, rest].count_nonzero().item():
        raise AssertionError(f"{v.name}: nonzero rows outside {v.rows}")
    a, b = got[:, v.rows], want[:, v.rows]
    err = (a.float() - b.float()).abs().max().item()
    if v.exact:
        ok, what = torch.equal(a, b), "equal"
    else:
        snr = snr_db(b, a)
        ok = snr >= 40.0
        what = (f"SNR {snr:.1f} dB (limit 40), "
                f"{'equal' if torch.equal(a, b) else 'not equal'} bit for bit")
    print(f"{v.name}: {what}, max|d| {err:.3e}, zeros outside rows "
          f"[{v.rows.start}, {v.rows.stop})", flush=True)
    if not ok:
        raise AssertionError(f"{v.name} disagrees with its plain version")
    return err


def measure(v: Variant, card: str):
    """Check, then time one variant; prints its line and returns its
    record."""
    before = v.wrapper.launches
    err = check(v)
    out = v.kernel()
    bms, by = bound_ms(nbytes(*v.inputs, out), v.flops, v.peak)
    kg, ke = graph_time(v.kernel, reps=REPS)[0], \
        cuda_time(v.kernel, reps=REPS)[0]
    pg, pe = graph_time(v.plain, reps=REPS)[0], \
        cuda_time(v.plain, reps=REPS)[0]
    lib = None if v.library is None else graph_time(v.library, reps=REPS)[0]
    print(f"{v.name}: ms per call, device (graph replay) / eager: kernel "
          f"{kg:.4f} / {ke:.4f}, plain {pg:.4f} / {pe:.4f}, library call "
          f"{'none' if lib is None else f'{lib:.4f}'}, bound {bms:.4f} "
          f"({by}) [{card}]", flush=True)
    return {"name": v.name, "launches": v.wrapper.launches - before,
            "max_abs_err": err, "ms": kg, "eager_ms": ke, "plain_ms": pg,
            "plain_eager_ms": pe, "bound_ms": bms, "bound_by": by,
            "library_ms": lib}


def run(make_variants, argv, title):
    """A probe's main: every variant of ``make_variants`` at batch
    ``argv[0]`` (default 24). Returns the variants' records."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = int(argv[0]) if argv else B
    card = card_line()
    print(f"{title}: (B, R, C) = ({batch}, {R}, {C}) bf16 [{card}]",
          flush=True)
    with torch.inference_mode():
        rows = [measure(v, card) for v in make_variants(*inputs(batch))]
    torch.cuda.synchronize()
    return rows


def main(argv):
    return run(variants, argv, "micro-kernels of the UConvBlock's ops")


if __name__ == "__main__":
    main(sys.argv[1:])
