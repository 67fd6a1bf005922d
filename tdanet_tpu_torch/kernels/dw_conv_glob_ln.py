"""Fused depthwise conv + GlobLN: the CUDA kernel's wrappers, its tile
and grid plan, and its plain PyTorch version.

Counterpart of ``tdanet_tpu/kernels/fused_pyramid.py::dw_conv_glob_ln`` and
``tdanet_tpu/kernels/fused_pyramid_chunked.py::dw_conv_glob_ln_chunked``,
with their signatures: x is (B, T, C), weight (C, 1, K) in torch's
depthwise layout, bias, gamma and beta (C,). Both wrappers run the one
kernel of ``csrc/dw_conv_glob_ln.cu``: one cooperative launch per call,
whose grid :func:`plan` sets.

On a CUDA tensor a wrapper launches the kernel or raises. On a CPU tensor,
and only there, it computes the plain version,
:func:`dw_conv_glob_ln_reference`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.ops import basic as ops

_STORAGE = {torch.float32: 0, torch.bfloat16: 1}
TILE_T, TILE_C = 128, 32  # a tile: output rows x channels (csrc kTileT, kTileC)


class Plan(NamedTuple):
    """The kernel's tiles and grid for one call."""
    tiles_t: int     # tiles of a sample along T_out
    tiles_c: int     # ... along C
    per_sample: int  # tiles_t * tiles_c
    n_tiles: int     # B * per_sample
    grid: int        # CTAs: min(capacity, n_tiles)


def plan(B, T_out, C, capacity):
    """The tile and grid plan of one launch. Tiles are numbered sample by
    sample, channel tile by channel tile, time tile fastest; the grid is
    at most ``capacity`` (the CTAs the card holds at once) and at most the
    tiles, and CTA j owns tiles [j N / G, (j+1) N / G)."""
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    tiles_t, tiles_c = -(-T_out // TILE_T), -(-C // TILE_C)
    n_tiles = B * tiles_t * tiles_c
    return Plan(tiles_t, tiles_c, tiles_t * tiles_c, n_tiles,
                min(capacity, n_tiles))


def dw_conv_glob_ln_reference(x, weight, bias, gamma, beta, *, stride=1,
                              K=5, eps=1e-8):
    """Plain PyTorch: depthwise Conv1d(groups=C, padding=(K-1)//2) then
    GlobLN. x (B, T, C) -> (B, T_out, C)."""
    C = x.shape[-1]
    y = ops.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                   padding=(K - 1) // 2, groups=C)
    return ops.glob_ln(y, gamma, beta, eps=eps).transpose(1, 2)


def _check(x, weight, bias, gamma, beta, stride, K):
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C), got shape {tuple(x.shape)}")
    B, T, C = x.shape
    if tuple(weight.shape) != (C, 1, K):
        raise ValueError(f"weight must be ({C}, 1, {K}), got "
                         f"{tuple(weight.shape)}")
    for name, p in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        if p is not None and tuple(p.shape) != (C,):
            raise ValueError(f"{name} must be ({C},), got {tuple(p.shape)}")
    if K % 2 == 0 or not 1 <= K <= 7:
        raise ValueError(f"K must be odd and at most 7, got {K}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if x.stride(1) != 1 and x.stride(2) != 1:
        raise ValueError(
            "one of T and C must be the innermost contiguous axis of x; got "
            f"strides {x.stride()}")
    if min(B, T, C) < 1:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")


def _as_f32(p, device):
    """A (C,) or (C, 1, K) parameter as a contiguous fp32 tensor; an
    fp32 parameter is passed as it is. It must already lie on x's device."""
    if p.device != device:
        raise ValueError(f"parameters must lie on {device}, got {p.device}")
    if p.dtype is torch.float32 and p.is_contiguous():
        return p
    return p.detach().to(torch.float32).contiguous()


def _params(weight, bias, gamma, beta, device):
    """The parameters as the kernel reads them: in their own storage when
    all of them lie on x's device, are contiguous and share fp32 or bf16
    (a bf16 model: no copy), else as fp32. Returns (weight, bias, gamma,
    beta, 1 if bf16 else 0)."""
    ps = (weight, bias, gamma, beta)
    dtypes = {p.dtype for p in ps if p is not None}
    if len(dtypes) == 1 and dtypes <= _STORAGE.keys() and all(
            p is None or (p.device == device and p.is_contiguous())
            for p in ps):
        return (*ps, _STORAGE[dtypes.pop()])
    return (*(None if p is None else _as_f32(p, device) for p in ps), 0)


def _launch(x, weight, bias, gamma, beta, stride, K, eps):
    if x.dtype not in _STORAGE:
        raise TypeError(f"the CUDA kernel stores fp32 or bf16, got {x.dtype}")
    if torch.is_grad_enabled() and any(
            p is not None and p.requires_grad
            for p in (x, weight, bias, gamma, beta)):
        raise RuntimeError("dw_conv_glob_ln has no backward kernel yet; call "
                           "it under torch.inference_mode() or no_grad()")
    B, T, C = x.shape
    T_out = (T + 2 * ((K - 1) // 2) - K) // stride + 1
    dev = x.device
    t_contig = x.stride(1) == 1
    if t_contig:  # the model's (B, C, T) tensor seen as (B, T, C)
        out = torch.empty((B, C, T_out), dtype=x.dtype,
                          device=dev).transpose(1, 2)
    else:
        out = torch.empty((B, T_out, C), dtype=x.dtype, device=dev)
    w, b, g, be, p_bf16 = _params(weight, bias, gamma, beta, dev)
    x_bf16 = _STORAGE[x.dtype]
    grid = plan(B, T_out, C, capacity(x_bf16, p_bf16, K, stride, t_contig,
                                      dev.index)).grid
    partials = torch.empty(4 * B * grid, dtype=torch.float32, device=dev)
    err = _library().dw_conv_glob_ln_launch(
        x.data_ptr(), out.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), g.data_ptr(), be.data_ptr(),
        partials.data_ptr(), B, T, C, T_out, K, stride, *x.stride(),
        *out.stride(), int(t_contig), x_bf16, p_bf16, grid, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw_conv_glob_ln launch failed: CUDA error {err}")
    dw_conv_glob_ln.launches += 1
    return out


@lru_cache(maxsize=None)
def capacity(x_bf16, p_bf16, K, stride, t_contig, device_index):
    """The most CTAs of the kernel for this storage, K, stride and layout
    that the card holds at once (occupancy x SMs): the largest grid a
    cooperative launch takes."""
    with torch.cuda.device(device_index):
        n = _library().dw_conv_glob_ln_capacity(
            x_bf16, p_bf16, K, stride, int(t_contig))
    if n < 1:
        raise RuntimeError(f"dw_conv_glob_ln occupancy query failed: {n}")
    return n


@lru_cache(maxsize=None)
def _library():
    lib = _build.load("dw_conv_glob_ln")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_conv_glob_ln_capacity.argtypes = [i] * 5
    lib.dw_conv_glob_ln_capacity.restype = i
    lib.dw_conv_glob_ln_launch.argtypes = (
        [p] * 7 + [i] * 6 + [ll] * 6 + [i] * 4 + [ctypes.c_float, p])
    lib.dw_conv_glob_ln_launch.restype = i
    return lib


def dw_conv_glob_ln(x, weight, bias, gamma, beta, *, stride=1, K=5,
                    eps=1e-8):
    """Depthwise K-tap conv, padding (K-1)//2, stride 1 or 2, + bias (or
    none), then GlobLN over each sample's (T_out, C) with fp32 statistics
    and a per-channel affine. x (B, T, C) -> (B, T_out, C).

    One of T and C must be x's innermost contiguous axis; the output has
    x's layout. ``launches`` counts the kernel's launches."""
    _check(x, weight, bias, gamma, beta, stride, K)
    if x.device.type == "cpu":
        return dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                         stride=stride, K=K, eps=eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"no dw_conv_glob_ln for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):  # a launch goes to this device
            return _launch(x, weight, bias, gamma, beta, stride, K, eps)
    return _launch(x, weight, bias, gamma, beta, stride, K, eps)


dw_conv_glob_ln.launches = 0


def dw_conv_glob_ln_chunked(x, weight, bias, gamma, beta, *, eps=1e-8):
    """The stride-1 form of :func:`dw_conv_glob_ln` with K taken from the
    weight, the signature of the JAX package's streamed two-pass kernel."""
    return dw_conv_glob_ln(x, weight, bias, gamma, beta, stride=1,
                           K=weight.shape[-1], eps=eps)
