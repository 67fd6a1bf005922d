"""Chunked against whole micro-kernels on the card (counterpart of
``scripts/probe_mosaic_ops2.py``).

    python -m tdanet_tpu_torch.probes.mosaic_ops2 [batch]

At (B, R, C) = (24, 2032, 512) bf16: copy; the five-tap FMA over 2016 rows
whole and in chunks of 512 and 128 rows; the projection product in chunks
of 512 and 128 rows and whole; statistics + normalise in chunks of 512
rows. A chunk is the rows one CTA takes. The script's chunked loops run
whole chunks only, and the kernels keep that: 1536 and 1920 rows of taps
and of products, statistics summed over 1536 rows and divided by R * C.
Checks, timing and output are those of ``probes.mosaic_ops``.
"""

from __future__ import annotations

import sys

import torch

from tdanet_tpu_torch.kernels import micro_ops as mo
from tdanet_tpu_torch.probes.mosaic_ops import (
    C, R, Variant, run, taps_library)

ROWS = 2016  # the taps' rows in this script


def variants(x, w, dec, wp):
    """The second script's eight kernels (``dec`` is not used)."""
    n = x.shape[0]
    x128 = x[:, :, :mo.PROJ_K]  # a view: the kernels read x in place
    out = [Variant("copy", mo.copy, lambda: mo.copy(x),
                   lambda: mo.copy_reference(x), (x,), slice(0, R),
                   exact=True, library=x.clone)]
    for chunk in (0, 512, 128):
        rows = ROWS if chunk == 0 else ROWS // chunk * chunk
        out.append(Variant(
            f"taps fp32 acc, {rows} rows, chunk {chunk or 'whole'}", mo.taps,
            lambda chunk=chunk: mo.taps(x, w, rows=ROWS, chunk=chunk),
            lambda chunk=chunk: mo.taps_reference(x, w, rows=ROWS,
                                                  chunk=chunk),
            (x[:, 6:rows + 10], w[:5]), slice(8, 8 + rows),
            2.0 * 5 * n * rows * C, library=taps_library(x, w, rows)))
    for chunk in (512, 128, 0):
        rows = R if chunk == 0 else R // chunk * chunk
        out.append(Variant(
            f"proj (128 -> 512), {rows} rows, chunk {chunk or 'whole'}",
            mo.proj, lambda chunk=chunk: mo.proj(x, wp, chunk=chunk),
            lambda chunk=chunk: mo.proj_reference(x, wp, chunk=chunk),
            (x128[:, :rows], wp), slice(0, rows),
            2.0 * n * rows * mo.PROJ_K * C, "bf16",
            library=lambda rows=rows: torch.matmul(x128[:, :rows], wp)))
    rows = R // 512 * 512
    out.append(Variant(
        f"stats + normalise, {rows} rows, chunk 512", mo.stats_normalize,
        lambda: mo.stats_normalize(x, chunk=512),
        lambda: mo.stats_normalize_reference(x, chunk=512), (x[:, :rows],),
        slice(0, rows), 5.0 * n * rows * C))
    return out


def main(argv):
    return run(variants, argv, "chunked against whole micro-kernels")


if __name__ == "__main__":
    main(sys.argv[1:])
