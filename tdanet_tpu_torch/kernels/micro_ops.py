"""Micro-kernels of the UConvBlock's ops: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of the Pallas micro-benchmarks in
``scripts/probe_mosaic_ops.py`` and ``scripts/probe_mosaic_ops2.py``: each
wrapper computes what one of the scripts' kernel bodies computes, on a
(B, R, C) bf16 tensor (the scripts' shape is (24, 2032, 512)), through
``csrc/micro_ops.cu``. ``chunk`` is the rows one CTA takes in one visit
(0: the whole sample, else 512 or 128), where a script walks a sample in
row chunks; a CTA may take a band of the channels only, so that the grid
covers the card. The two matrix products are built from
``csrc/hopper_gemm.cuh`` (TMA loads through an mbarrier ring, wgmma).

The scripts have quirks, kept here because what the TPU kernel computes is
the yardstick; each wrapper's docstring states its own. Rows that a
script's body never writes are undefined there; here they are zeros.

On a CUDA tensor a wrapper launches the kernel or raises. On a CPU tensor,
and only there, it computes the plain version (``*_reference``). Each
wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tdanet_tpu_torch.kernels import _build

PROJ_K = 128          # the projection's input channels
PROJ_MAX_C = 512      # its widest output: the whole weight stays on the SM
_CHUNKS = (0, 512, 128)


@lru_cache(maxsize=None)
def _library():
    lib = _build.load("micro_ops")
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.micro_copy.argtypes = [p, p, i, i, i, p]
    lib.micro_repeat.argtypes = [p, p, i, i, i, i, p]
    lib.micro_taps.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.micro_decimate.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.micro_proj.argtypes = [p, ll, ll, p, p, i, i, i, i, i, p]
    lib.micro_stats_scratch.argtypes = [i, i, i, i]
    lib.micro_stats_scratch.restype = ll
    lib.micro_stats.argtypes = [p, p, p, i, i, i, i, i, f, p]
    for name in ("micro_copy", "micro_repeat", "micro_taps",
                 "micro_decimate", "micro_proj", "micro_stats"):
        getattr(lib, name).restype = i
    return lib


def _check_x(x, channels=None, in_place=False):
    """``in_place``: the kernel reads x through its strides (unit channel
    stride), so the sample and row strides must be multiples of 16 bytes as
    well as the address; otherwise a view is copied first and only a
    contiguous x is read where it lies."""
    if x.ndim != 3 or x.dtype is not torch.bfloat16:
        raise TypeError(f"x must be a bf16 (B, R, C) tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    B, R, C = x.shape
    C = channels or C
    if min(B, R) < 1 or C % 64 or R * C >= 2 ** 31 or B > 65535:
        raise ValueError(f"B={B}, R={R}, C={C}: C must be a multiple of 64, "
                         "a sample below 2**31 elements, B at most 65535")
    if (in_place or x.is_contiguous()) and x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernels "
                         "move 16-byte vectors)")
    if in_place and (x.stride(0) % 8 or x.stride(1) % 8):
        raise ValueError(f"x is read in place: its sample and row strides "
                         f"{x.stride()[:2]} must be multiples of 8 elements "
                         "(16 bytes)")


def _check_chunk(chunk, allowed=_CHUNKS):
    if chunk not in allowed:
        raise ValueError(f"chunk must be one of {allowed}, got {chunk}")


def _on_card(x, name):
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor; raises elsewhere."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"no {name} for device {x.device}")
    return True


def _operand(t, x, dtype, shape, name):
    if t.dtype is not dtype or tuple(t.shape) != tuple(shape) \
            or t.device != x.device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on "
                         f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _run(fn, wrapper, x, *args):
    """Launch ``fn`` on x's device and stream; count it for ``wrapper``."""
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1


def _whole_chunks(n, chunk):
    """The rows a script's chunked loop covers: n // chunk whole chunks."""
    return n if chunk == 0 else (n // chunk) * chunk


# ---------------------------------------------------------------------------
# copy, repeat
# ---------------------------------------------------------------------------


def copy_reference(x):
    return x.clone()


def copy(x):
    """out = x (the scripts' baseline)."""
    _check_x(x)
    if not _on_card(x, "copy"):
        return copy_reference(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    _run(_library().micro_copy, copy, x, x.data_ptr(), out.data_ptr(),
         *x.shape)
    return out


def repeat2_reference(x, n_src=1005):
    out = torch.zeros_like(x)
    out[:, :2 * n_src] = torch.repeat_interleave(x[:, :n_src], 2, dim=1)
    return out


def repeat2(x, n_src=1005):
    """Rows [0, n_src) of x, each twice, into rows [0, 2 * n_src); zeros
    below."""
    _check_x(x)
    if not 0 <= 2 * n_src <= x.shape[1]:
        raise ValueError(f"2 * {n_src} rows do not fit {x.shape[1]}")
    if not _on_card(x, "repeat2"):
        return repeat2_reference(x, n_src)
    x = x.contiguous()
    out = torch.empty_like(x)
    _run(_library().micro_repeat, repeat2, x, x.data_ptr(), out.data_ptr(),
         *x.shape, n_src)
    return out


# ---------------------------------------------------------------------------
# five-tap FMA
# ---------------------------------------------------------------------------


def taps_reference(x, w, *, rows=2010, acc=torch.float32, chunk=0):
    n = _whole_chunks(rows, chunk)
    total = None
    for k in range(5):
        term = x[:, 6 + k:6 + k + n].to(acc) * w[k].to(acc)[None, None, :]
        total = term if total is None else total + term
    out = torch.zeros_like(x)
    out[:, 8:8 + n] = total.to(x.dtype)
    return out


def taps(x, w, *, rows=2010, acc=torch.float32, chunk=0):
    """out[8 + r] = sum_k x[6 + k + r] * w[k] for r in [0, n), zeros
    elsewhere; w is fp32 (8, C), of which five rows are taps. ``acc`` is
    the accumulation type: fp32, or bf16 with the taps, every product and
    every sum rounded to bf16.

    Quirk kept from the second script: a chunked walk covers only
    ``rows // chunk`` whole chunks, so with rows 2016, chunk 512 computes
    n = 1536 rows and chunk 128 n = 1920; chunk 0 computes n = rows.

    Bound by bytes. A thread takes two channels and walks its rows with
    the five input rows in registers; a chunked CTA takes 256 channels, the
    CTA of a whole sample a 64-channel band whose eight warps walk an
    eighth of the rows each."""
    _check_x(x)
    _check_chunk(chunk)
    if acc not in (torch.float32, torch.bfloat16) or (
            acc is torch.bfloat16 and chunk):
        raise ValueError("acc is fp32, or bf16 with chunk 0")
    n = _whole_chunks(rows, chunk)
    B, R, C = x.shape
    if n < 1 or n + 10 > R:
        raise ValueError(f"{n} output rows need {n + 10} input rows, x has "
                         f"{R}")
    if not _on_card(x, "taps"):
        return taps_reference(x, w, rows=rows, acc=acc, chunk=chunk)
    x = x.contiguous()
    w = _operand(w, x, torch.float32, (8, C), "w")
    out = torch.empty_like(x)
    _run(_library().micro_taps, taps, x, x.data_ptr(), w.data_ptr(),
         out.data_ptr(), B, R, C, n, chunk, int(acc is torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# decimation product
# ---------------------------------------------------------------------------


def decimate_reference(x, dec):
    y = torch.matmul(dec, x.to(dec.dtype))
    out = torch.zeros_like(x)
    out[:, :dec.shape[0]] = y.to(x.dtype)
    return out


def decimate(x, dec):
    """out[:, :M] = dec @ x per sample, zeros below; dec is (M, R), shared
    by the samples. An fp32 dec multiplies fp32 operands (x converted), a
    bf16 dec bf16 operands; both accumulate in fp32. R must be a multiple
    of 8 (dec's rows are moved in 16-byte pieces).

    Both are bound by operations on the H100. bf16 operands run on the
    tensor cores: 128 x 256 output tiles, wgmma on 64-deep k slices that
    TMA loads bring through a 4-stage ring, dec's ragged edges zero-filled
    by the loads; the zero rows below the last row tile are written by CTAs
    that do nothing else. fp32 operands stay on the SIMT cores (TF32 would
    change the numbers): 128 x 128 tiles, 8 x 8 outputs a thread, dec
    double-buffered by ``cp.async``."""
    _check_x(x)
    B, R, C = x.shape
    if R % 8:
        raise ValueError(f"R={R} must be a multiple of 8")
    if dec.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dec must be fp32 or bf16, got {dec.dtype}")
    if dec.ndim != 2 or dec.shape[1] != R or not 1 <= dec.shape[0] <= R:
        raise ValueError(f"dec must be (M <= {R}, {R}), got "
                         f"{tuple(dec.shape)}")
    if not _on_card(x, "decimate"):
        return decimate_reference(x, dec)
    x = x.contiguous()
    dec = _operand(dec, x, dec.dtype, dec.shape, "dec")
    out = torch.empty_like(x)
    _run(_library().micro_decimate, decimate, x, x.data_ptr(),
         dec.data_ptr(), out.data_ptr(), B, R, C, dec.shape[0],
         int(dec.dtype is torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# projection product
# ---------------------------------------------------------------------------


def proj_reference(x, w, *, chunk=0):
    B, R = x.shape[:2]
    n = _whole_chunks(R, chunk)
    out = torch.zeros((B, R, w.shape[1]), dtype=x.dtype, device=x.device)
    out[:, :n] = torch.matmul(x[:, :n, :PROJ_K], w)
    return out


def proj(x, w, *, chunk=0):
    """out[:, :n] = x[:, :n, :128] @ w, zeros below: bf16 operands, fp32
    accumulation; x is (B, R, >= 128) with unit channel stride, read in
    place (address and strides multiples of 16 bytes), w bf16 (128, C),
    C at most 512.

    Quirk kept from the second script: a chunked walk covers only
    ``R // chunk`` whole chunks, so at R 2032 chunk 512 computes n = 1536
    rows and chunk 128 n = 1920; chunk 0 computes all R.

    Bound by bytes on the H100 (the output is four times the input), so
    every byte moves once: one persistent CTA per SM stages the whole
    weight in shared memory, then takes its share of the visits. A visit is
    ``chunk`` rows of one sample, walked in 128-row tiles that TMA loads
    bring through a 3-stage ring and wgmma multiplies by each 256-column
    half of the weight; the visits are split evenly among the CTAs in
    contiguous runs. ``chunk`` 0, the whole sample, no longer means one
    under-filled CTA per sample and column tile: a visit is then one
    128-row tile, the last of a sample ragged, so the grid is full and only
    the rows covered tell it from chunk 128."""
    _check_chunk(chunk)
    if w.ndim != 2 or w.shape[0] != PROJ_K or w.shape[1] > PROJ_MAX_C:
        raise ValueError(f"w must be ({PROJ_K}, C <= {PROJ_MAX_C}), got "
                         f"{tuple(w.shape)}")
    if x.ndim == 3 and x.stride(2) != 1:
        x = x.contiguous()
    _check_x(x, channels=w.shape[1], in_place=True)
    B, R = x.shape[:2]
    C = w.shape[1]
    if x.shape[2] < PROJ_K:
        raise ValueError(f"x needs {PROJ_K} channels, got {x.shape[2]}")
    if not _on_card(x, "proj"):
        return proj_reference(x, w, chunk=chunk)
    w = _operand(w, x, torch.bfloat16, (PROJ_K, C), "w")
    out = torch.empty((B, R, C), dtype=x.dtype, device=x.device)
    _run(_library().micro_proj, proj, x, x.data_ptr(), x.stride(0),
         x.stride(1), w.data_ptr(), out.data_ptr(), B, R, C,
         _whole_chunks(R, chunk), chunk)
    return out


# ---------------------------------------------------------------------------
# statistics + normalise
# ---------------------------------------------------------------------------


def stats_normalize_reference(x, *, chunk=0, eps=1e-8):
    B, R, C = x.shape
    n = _whole_chunks(R, chunk)
    y = x[:, :n].float()
    mean = y.sum(dim=(1, 2), keepdim=True) / (R * C)
    sq = (y * y).sum(dim=(1, 2), keepdim=True) / (R * C)
    rstd = torch.rsqrt(sq - mean * mean + eps)
    out = torch.zeros_like(x)
    out[:, :n] = ((y - mean) * rstd).to(x.dtype)
    return out


def stats_normalize(x, *, chunk=0, eps=1e-8):
    """One-pass fp32 sum and sum of squares over a sample, then
    (x - mean) * rsqrt(var + eps), no affine.

    Quirk kept from the second script: with chunk 512 the sums run over
    ``R // 512`` whole chunks only (1536 of 2032 rows) and are still divided
    by R * C; those rows are normalised and the rows below are zeros. chunk
    0 takes every row.

    Bound by bytes. Two launches: per-tile sums, then every CTA merges the
    sample's tiles in one fixed order (no atomics) and normalises its own.
    A tile is 16 rows of every channel for chunk 0 and 512 rows of a
    64-channel band for chunk 512."""
    _check_x(x)
    _check_chunk(chunk, (0, 512))
    B, R, C = x.shape
    n = _whole_chunks(R, chunk)
    if n < 1:
        raise ValueError(f"no whole chunk of {chunk} rows in {R}")
    if not _on_card(x, "stats_normalize"):
        return stats_normalize_reference(x, chunk=chunk, eps=eps)
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = _library()
    partials = torch.empty(lib.micro_stats_scratch(B, C, n, chunk),
                           dtype=torch.float32, device=x.device)
    _run(lib.micro_stats, stats_normalize, x, x.data_ptr(), out.data_ptr(),
         partials.data_ptr(), B, R, C, n, chunk, eps)
    return out


WRAPPERS = (copy, repeat2, taps, decimate, proj, stats_normalize)
for _w in WRAPPERS:
    _w.launches = 0
