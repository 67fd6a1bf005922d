"""Swin window partition and merge with the cyclic shift fused in: the CUDA
kernels' wrappers, their gradients and their plain PyTorch versions.

Counterpart of ``tdanet_tpu/kernels/window_process.py``, with its
signatures:

- ``roll_and_window_partition(x, shift_size, window_size)``:
  (B, H, W, C) -> (B*nH*nW, ws, ws, C), rolled by -shift on H and W first;
- ``window_merge_and_roll(windows, shift_size, window_size, H, W)``: the
  inverse, rolled by +shift afterwards.

Each is a ``torch.autograd.Function`` whose backward is the other op with
the same shift, as the JAX package's custom VJPs pair them. Both run the
one kernel of ``csrc/window_process.cu``, which moves bytes and takes any
element size.

On a CUDA tensor a wrapper launches the kernel or raises. On a CPU tensor,
and only there, it computes the plain version (``*_reference``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tdanet_tpu_torch.kernels import _build

# the kernel indexes vectors in 32 bits
_MAX_ELEMENTS = 2 ** 31


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def window_partition(x, window_size: int):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C)."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows, window_size: int, H: int, W: int):
    """(B*nH*nW, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def roll_and_window_partition_reference(x, shift_size: int,
                                        window_size: int):
    if shift_size > 0:
        x = torch.roll(x, (-shift_size, -shift_size), dims=(1, 2))
    return window_partition(x, window_size)


def window_merge_and_roll_reference(windows, shift_size: int,
                                    window_size: int, H: int, W: int):
    x = window_reverse(windows, window_size, H, W)
    if shift_size > 0:
        x = torch.roll(x, (shift_size, shift_size), dims=(1, 2))
    return x


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def _check(shape, shift, ws, H, W):
    if ws < 1 or H % ws or W % ws:
        raise ValueError(f"H={H} and W={W} must be multiples of the window "
                         f"size {ws}")
    if not 0 <= shift < ws:
        raise ValueError(f"shift must be in [0, {ws}), got {shift}")
    n = 1
    for d in shape:
        n *= d
    if n < 1:
        raise ValueError(f"empty input of shape {tuple(shape)}")
    if n >= _MAX_ELEMENTS:
        raise ValueError(f"{n} elements: the kernel indexes in 32 bits and "
                         f"takes fewer than {_MAX_ELEMENTS}")


@lru_cache(maxsize=None)
def _library():
    lib = _build.load("window_process")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.window_process_launch.argtypes = (
        [p, p, i, i, i, ctypes.c_longlong, i, i, i, i, p])
    lib.window_process_launch.restype = i
    return lib


def _launch(src, out_shape, B, H, W, ws, shift, merge):
    """One launch: ``src`` (made contiguous once, since a gradient may
    arrive as a view) into a new contiguous tensor of ``out_shape``."""
    if src.is_complex() or src.dtype is torch.bool:
        raise TypeError(f"the window kernels take real number types, got "
                        f"{src.dtype}")
    src = src.contiguous()
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    row_bytes = src.shape[-1] * src.element_size()
    vec = 16
    while row_bytes % vec or src.data_ptr() % vec or out.data_ptr() % vec:
        vec //= 2
    with torch.cuda.device(src.device):
        err = _library().window_process_launch(
            src.data_ptr(), out.data_ptr(), B, H, W, row_bytes, ws, shift,
            int(merge), vec,
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_process launch failed: CUDA error {err}")
    return out


def _partition(x, shift, ws):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    _check(x.shape, shift, ws, H, W)
    if x.device.type == "cpu":
        return roll_and_window_partition_reference(x, shift, ws)
    if x.device.type != "cuda":
        raise RuntimeError(f"no roll_and_window_partition for {x.device}")
    out = _launch(x, (B * (H // ws) * (W // ws), ws, ws, C), B, H, W, ws,
                  shift, merge=False)
    roll_and_window_partition.launches += 1
    return out


def _merge(windows, shift, ws, H, W):
    if windows.ndim != 4 or windows.shape[1:3] != (ws, ws):
        raise ValueError(f"windows must be (B*nH*nW, {ws}, {ws}, C), got "
                         f"{tuple(windows.shape)}")
    _check(windows.shape, shift, ws, H, W)
    nwin = (H // ws) * (W // ws)
    if windows.shape[0] % nwin:
        raise ValueError(f"{windows.shape[0]} windows do not fill images of "
                         f"{nwin} windows")
    B, C = windows.shape[0] // nwin, windows.shape[-1]
    if windows.device.type == "cpu":
        return window_merge_and_roll_reference(windows, shift, ws, H, W)
    if windows.device.type != "cuda":
        raise RuntimeError(f"no window_merge_and_roll for {windows.device}")
    out = _launch(windows, (B, H, W, C), B, H, W, ws, shift, merge=True)
    window_merge_and_roll.launches += 1
    return out


class _RollPartition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift, ws):
        ctx.args = (shift, ws, x.shape[1], x.shape[2])
        return _partition(x, shift, ws)

    @staticmethod
    def backward(ctx, grad):
        return _merge(grad, *ctx.args), None, None


class _MergeRoll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, windows, shift, ws, H, W):
        ctx.args = (shift, ws)
        return _merge(windows, shift, ws, H, W)

    @staticmethod
    def backward(ctx, grad):
        return _partition(grad, *ctx.args), None, None, None, None


def roll_and_window_partition(x, shift_size: int, window_size: int):
    """(B, H, W, C) -> (B*nH*nW, ws, ws, C): cyclic shift by -shift_size on
    H and W, then the window partition, in one kernel. Its gradient is
    :func:`window_merge_and_roll` with the same shift. ``launches`` counts
    this kernel's launches, forward or as the other op's gradient."""
    return _RollPartition.apply(x, int(shift_size), int(window_size))


def window_merge_and_roll(windows, shift_size: int, window_size: int,
                          H: int, W: int):
    """(B*nH*nW, ws, ws, C) -> (B, H, W, C): the window merge, then the
    cyclic shift by +shift_size, in one kernel. Its gradient is
    :func:`roll_and_window_partition` with the same shift."""
    return _MergeRoll.apply(windows, int(shift_size), int(window_size),
                            int(H), int(W))


roll_and_window_partition.launches = 0
window_merge_and_roll.launches = 0

# the reference's names for the pair
WindowProcess = roll_and_window_partition
WindowProcessReverse = window_merge_and_roll
