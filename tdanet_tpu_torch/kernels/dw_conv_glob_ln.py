"""Fused depthwise conv + GlobLN, forward and backward: the CUDA kernels'
wrappers, their tile and grid plan, their plain PyTorch versions and the
autograd Function that joins them.

Counterpart of ``tdanet_tpu/kernels/fused_pyramid.py::dw_conv_glob_ln`` and
``tdanet_tpu/kernels/fused_pyramid_chunked.py::dw_conv_glob_ln_chunked``,
with their signatures: x is (B, T, C), weight (C, 1, K) in torch's
depthwise layout, bias, gamma and beta (C,). Both wrappers run the one
kernel of ``csrc/dw_conv_glob_ln.cu``: one cooperative launch per call,
whose grid :func:`plan` sets. Where a gradient is wanted, the forward
kernel also writes each sample's statistics and the backward is
``csrc/dw_conv_glob_ln_backward.cu`` (:func:`dw_conv_glob_ln_backward`),
one cooperative launch too. The JAX package has no backward kernel: its
trainer differentiates the plain ConvNorm, which
:func:`dw_conv_glob_ln_backward_reference` writes out.

On a CUDA tensor a wrapper launches its kernel or raises. On a CPU tensor,
and only there, it computes the plain version,
:func:`dw_conv_glob_ln_reference` (autograd differentiates it).

The forward without a gradient is the registered op
``torch.ops.tdanet_tpu_torch.dw_conv_glob_ln`` (:data:`OP`): its CUDA
implementation is the kernel's launch, its CPU implementation the plain
version, and its fake implementation gives the kernel's output layout, so
``torch.export`` keeps one node a site and an exported program launches
the kernel when it runs on the card (``tdanet_tpu_torch/deploy.py``).
Outside a trace the wrapper calls the implementation directly.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.ops import basic as ops

_STORAGE = {torch.float32: 0, torch.bfloat16: 1}
TILE_T, TILE_C = 128, 32  # a tile: output rows x channels (csrc kTileT, kTileC)


class Plan(NamedTuple):
    """The forward kernel's tiles and grid for one call."""
    tiles_t: int     # tiles of a sample along T_out
    tiles_c: int     # ... along C
    per_sample: int  # tiles_t * tiles_c
    n_tiles: int     # B * per_sample
    grid: int        # CTAs: min(capacity, n_tiles)


def plan(B, T_out, C, capacity):
    """The forward kernel's tile and grid plan for one launch. Tiles of
    128 output rows by 32 channels are numbered sample by sample, channel
    tile by channel tile, time tile fastest; the grid is at most
    ``capacity`` (the CTAs the card holds at once) and at most the tiles,
    and CTA j owns tiles [j N / G, (j+1) N / G)."""
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    tiles_t, tiles_c = -(-T_out // TILE_T), -(-C // TILE_C)
    n_tiles = B * tiles_t * tiles_c
    return Plan(tiles_t, tiles_c, tiles_t * tiles_c, n_tiles,
                min(capacity, n_tiles))


class BackwardPlan(NamedTuple):
    """One launch of the backward kernel as its library plans it
    (csrc/dw_conv_glob_ln_backward.cu make_plan)."""
    tile_t: int      # output rows a tile
    tile_c: int      # channels a tile
    slot: int        # bytes of a tile's slot in shared memory
    fixed: int       # bytes of shared memory before the slots
    n_tiles: int
    grid: int        # CTAs: min(capacity, n_tiles)
    max_slots: int   # tile slots a CTA's shared memory holds
    segs: int        # channel tiles one CTA's run touches, at most
    smem: int        # dynamic shared memory of the launch, bytes
    kept: int        # tiles kept in shared memory from phase 1 to 2
    cparts: int      # floats of the per-(CTA, channel tile) sums


def backward_rows(T_out, stride, t_contig):
    """The output rows a thread of the backward kernel owns: 16 at the
    stride-1 sites where T is innermost (each tile's fixed costs over
    twice the rows), unless one tile of 8 rows a thread (256) already
    covers T_out; 8 elsewhere, the only instance there. On an H100, 16
    rows took 6-24% less time than 8 at the training recipe's T 3010-377
    stride-1 sites and 11% more at T 189 (``probes/dw_backward.py
    --rows``)."""
    return 16 if t_contig and stride == 1 and T_out > 256 else 8


@lru_cache(maxsize=4096)
def backward_plan(x_bf16, K, stride, t_contig, rows, B, T_out, C,
                  device_index):
    """The library's :class:`BackwardPlan` for the instance (storage, K,
    stride, layout, ``rows`` a thread) at (B, T_out, C), with the grid the
    card ``device_index`` holds at once."""
    cap = backward_capacity(x_bf16, K, stride, t_contig, rows, device_index)
    out = (ctypes.c_longlong * len(BackwardPlan._fields))()
    err = _backward_library().dw_conv_glob_ln_backward_plan(
        x_bf16, K, stride, int(t_contig), rows, B, T_out, C, cap, out)
    if err != 0:
        raise RuntimeError(f"dw_conv_glob_ln_backward has no plan for "
                           f"{x_bf16, K, stride, t_contig, rows} at "
                           f"{B, T_out, C}: CUDA error {err}")
    return BackwardPlan(*out)


def dw_conv_glob_ln_reference(x, weight, bias, gamma, beta, *, stride=1,
                              K=5, eps=1e-8):
    """Plain PyTorch: depthwise Conv1d(groups=C, padding=(K-1)//2) then
    GlobLN. x (B, T, C) -> (B, T_out, C)."""
    C = x.shape[-1]
    y = ops.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                   padding=(K - 1) // 2, groups=C)
    return ops.glob_ln(y, gamma, beta, eps=eps).transpose(1, 2)


def stats_reference(x, weight, bias, *, stride=1, K=5, eps=1e-8):
    """Each sample's statistics as the forward kernel writes them, from
    the plain one-pass form of ``ops.glob_ln``: (B, 3) of (hi, lo, rstd),
    here with hi the mean and lo 0, in x's accumulation dtype."""
    C = x.shape[-1]
    y = ops.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                   padding=(K - 1) // 2, groups=C).to(ops.acc_dtype(x.dtype))
    mean = y.mean(dim=(1, 2))
    var = torch.clamp(y.square().mean(dim=(1, 2)) - mean.square(), min=0.0)
    return torch.stack([mean, torch.zeros_like(mean),
                        torch.rsqrt(var + eps)], dim=1)


def dw_conv_glob_ln_backward_reference(dy, x, weight, bias, gamma, *,
                                       stride=1, K=5, eps=1e-8, stats=None):
    """Plain PyTorch: the gradients of :func:`dw_conv_glob_ln_reference`
    written out, in x's accumulation dtype (at least fp32).

    With y = dwconv(x) + bias, xh = (y - mean) * rstd, g = dy * gamma,
    A = mean(g) and M = mean(g * xh) per sample over (T_out, C):
    dgamma = sum dy * xh, dbeta = sum dy, dz = rstd * (g - A - xh * M),
    dbias = sum dz, dweight[c, k] = sum_t dz[t, c] x[t S + k - P, c] and dx
    the transposed depthwise conv of dz. ``stats`` (B, 3) of (hi, lo,
    rstd) as the forward kernel writes them, or None for the plain
    one-pass statistics. Returns (dx, dweight, dbias or None, dgamma,
    dbeta), each in its operand's dtype; dy in x's (B, T_out, C) form."""
    B, T, C = x.shape
    P = (K - 1) // 2
    acc = ops.acc_dtype(x.dtype)
    xc = x.transpose(1, 2).to(acc)
    w = weight.to(acc)
    y = F.conv1d(xc, w, None if bias is None else bias.to(acc),
                 stride=stride, padding=P, groups=C)
    T_out = y.shape[-1]
    if stats is None:
        stats = stats_reference(x.to(acc), w, None if bias is None
                                else bias.to(acc), stride=stride, K=K,
                                eps=eps)
    st = stats.to(acc)[:, :, None, None]
    xh = ((y - st[:, 0]) - st[:, 1]) * st[:, 2]
    d = dy.transpose(1, 2).to(acc)
    dgamma = (d * xh).sum(dim=(0, 2))
    dbeta = d.sum(dim=(0, 2))
    g = d * gamma.to(acc)[None, :, None]
    A = g.mean(dim=(1, 2), keepdim=True)
    M = (g * xh).mean(dim=(1, 2), keepdim=True)
    dz = st[:, 2] * (g - A - xh * M)
    xpad = F.pad(xc, (P, P))
    span = stride * (T_out - 1) + 1
    dweight = torch.stack([(dz * xpad[..., k:k + span:stride]).sum(dim=(0, 2))
                           for k in range(K)], dim=1)[:, None, :]
    dx = F.conv_transpose1d(dz, w, stride=stride, padding=P, groups=C,
                            output_padding=T - span)
    return (dx.transpose(1, 2).to(x.dtype), dweight.to(weight.dtype),
            None if bias is None else dz.sum(dim=(0, 2)).to(bias.dtype),
            dgamma.to(gamma.dtype), dbeta.to(gamma.dtype))


def supports(K, stride):
    """Whether #1 serves a depthwise site of kernel K and this stride: K
    odd and at most 7, stride 1 or 2 (the TPU kernel's range)."""
    return K % 2 == 1 and 1 <= K <= 7 and stride in (1, 2)


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
    if not supports(K, stride):
        raise ValueError(f"K must be odd and at most 7 and stride 1 or 2, "
                         f"got K {K}, stride {stride}")
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


def _like(x, T_rows):
    """An empty (B, T_rows, C) tensor in x's dtype and layout: T innermost
    when it is x's innermost axis (the model's (B, C, T) tensor seen as
    (B, T, C)), else C."""
    B, _, C = x.shape
    if x.stride(1) == 1:
        return torch.empty((B, C, T_rows), dtype=x.dtype,
                           device=x.device).transpose(1, 2)
    return torch.empty((B, T_rows, C), dtype=x.dtype, device=x.device)


def _out_len(T, K, stride):
    return (T + 2 * ((K - 1) // 2) - K) // stride + 1


def _launch(x, weight, bias, gamma, beta, stride, K, eps, want_stats=False):
    """One launch of the forward kernel. Returns (out, stats): stats is
    each sample's fp32 (hi, lo, rstd), (B, 3), when asked for, else None."""
    if x.dtype not in _STORAGE:
        raise TypeError(f"the CUDA kernel stores fp32 or bf16, got {x.dtype}")
    B, T, C = x.shape
    T_out = _out_len(T, K, stride)
    dev = x.device
    t_contig = x.stride(1) == 1
    out = _like(x, T_out)
    w, b, g, be, p_bf16 = _params(weight, bias, gamma, beta, dev)
    x_bf16 = _STORAGE[x.dtype]
    grid = plan(B, T_out, C, capacity(x_bf16, p_bf16, K, stride, t_contig,
                                      dev.index)).grid
    partials = torch.empty(4 * B * grid, dtype=torch.float64, device=dev)
    stats = (torch.empty((B, 3), dtype=torch.float32, device=dev)
             if want_stats else None)
    err = _library().dw_conv_glob_ln_launch(
        x.data_ptr(), out.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), g.data_ptr(), be.data_ptr(),
        partials.data_ptr(), None if stats is None else stats.data_ptr(),
        B, T, C, T_out, K, stride, *x.stride(),
        *out.stride(), int(t_contig), x_bf16, p_bf16, grid, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw_conv_glob_ln launch failed: CUDA error {err}")
    dw_conv_glob_ln.launches += 1
    return out, stats


def _launch_backward(dy, x, weight, bias, gamma, stats, stride, K,
                     rows=None):
    """One launch of the backward kernel, with ``rows`` a thread
    (:func:`backward_rows` when None). dy has the forward output's
    innermost axis (T exactly when it is x's), with its own strides.
    Returns (dx, dweight, dbias or None, dgamma, dbeta): dx in x's dtype
    and layout, each parameter's gradient in that parameter's dtype."""
    B, T, C = x.shape
    T_out = dy.shape[1]
    dev = x.device
    t_contig = x.stride(1) == 1
    dx = _like(x, T)
    w, b, g, _, p_bf16 = _params(weight, bias, gamma, gamma, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dw, db, dg, dbe = (torch.empty((C, K), **f32), torch.empty(C, **f32),
                       torch.empty(C, **f32), torch.empty(C, **f32))
    x_bf16 = _STORAGE[x.dtype]
    rows = rows or backward_rows(T_out, stride, t_contig)
    bp = backward_plan(x_bf16, K, stride, t_contig, rows, B, T_out, C,
                       dev.index)
    parts = torch.empty(2 * B * bp.grid, dtype=torch.float64, device=dev)
    cparts = torch.empty(bp.cparts, **f32)
    err = _backward_library().dw_conv_glob_ln_backward_launch(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), g.data_ptr(), stats.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), dg.data_ptr(),
        dbe.data_ptr(), parts.data_ptr(), cparts.data_ptr(), B, T, C,
        T_out, K, stride, *x.stride(), *dy.stride(), *dx.stride(),
        int(t_contig), x_bf16, p_bf16, rows, bp.grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"dw_conv_glob_ln_backward launch failed: CUDA error {err}")
    dw_conv_glob_ln_backward.launches += 1
    return (dx, dw.reshape(C, 1, K).to(weight.dtype),
            None if bias is None else db.to(bias.dtype),
            dg.to(gamma.dtype), dbe.to(gamma.dtype))


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
def backward_capacity(x_bf16, K, stride, t_contig, rows, device_index):
    """The most CTAs of the backward kernel for this storage, K, stride,
    layout and rows a thread that the card holds at once, at the most
    shared memory a CTA takes (one an SM)."""
    with torch.cuda.device(device_index):
        n = _backward_library().dw_conv_glob_ln_backward_capacity(
            x_bf16, K, stride, int(t_contig), rows)
    if n < 1:
        raise RuntimeError(
            f"dw_conv_glob_ln_backward occupancy query failed: {n}")
    return n


@lru_cache(maxsize=None)
def _library():
    lib = _build.load("dw_conv_glob_ln")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_conv_glob_ln_capacity.argtypes = [i] * 5
    lib.dw_conv_glob_ln_capacity.restype = i
    lib.dw_conv_glob_ln_launch.argtypes = (
        [p] * 8 + [i] * 6 + [ll] * 6 + [i] * 4 + [ctypes.c_float, p])
    lib.dw_conv_glob_ln_launch.restype = i
    return lib


@lru_cache(maxsize=None)
def _backward_library():
    lib = _build.load("dw_conv_glob_ln_backward")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_conv_glob_ln_backward_capacity.argtypes = [i] * 5
    lib.dw_conv_glob_ln_backward_capacity.restype = i
    lib.dw_conv_glob_ln_backward_plan.argtypes = [i] * 9 + [p]
    lib.dw_conv_glob_ln_backward_plan.restype = i
    lib.dw_conv_glob_ln_backward_launch.argtypes = (
        [p] * 13 + [i] * 6 + [ll] * 9 + [i] * 5 + [p])
    lib.dw_conv_glob_ln_backward_launch.restype = i
    return lib


class DwConvGlobLnFunction(torch.autograd.Function):
    """The forward kernel with its statistics saved, and the backward
    kernel as its gradient (both on the current stream, the backward in
    autograd's thread). The kernel reads dy with its own strides when its
    innermost axis is the output's (the training step's every dy); any
    other dy is first made contiguous in the output's layout, and
    ``dy_copies`` counts those copies. dx comes back in x's layout and
    dtype, each parameter's gradient in the parameter's own dtype (fp32
    master weights under bf16 activations)."""

    dy_copies = 0

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, stride, K, eps):
        out, stats = _launch(x, weight, bias, gamma, beta, stride, K, eps,
                             want_stats=True)
        ctx.save_for_backward(x, weight, bias, gamma, stats)
        ctx.stride, ctx.K = stride, K
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, gamma, stats = ctx.saved_tensors
        inner = 1 if x.stride(1) == 1 else 2
        if dy.stride(inner) != 1 or min(dy.stride()) < 0:
            DwConvGlobLnFunction.dy_copies += 1
            if inner == 1:
                dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
            else:
                dy = dy.contiguous()
        grads = _launch_backward(dy, x, weight, bias, gamma, stats,
                                 ctx.stride, ctx.K)
        return (*grads, None, None, None)


# The forward as the registered op ``tdanet_tpu_torch::dw_conv_glob_ln``, so
# that a tracer (torch.export) records one node a site and an exported
# program calls the kernel again when it runs. Registered through
# ``torch.library.Library`` with a Python kernel a device: the dispatcher's
# lowest-cost route for a Python implementation.
_LIB = torch.library.Library("tdanet_tpu_torch", "DEF")
_LIB.define("dw_conv_glob_ln(Tensor x, Tensor weight, Tensor? bias, "
            "Tensor gamma, Tensor beta, int stride, int K, float eps) "
            "-> Tensor")


def _op_cuda(x, weight, bias, gamma, beta, stride, K, eps):
    """The op on the card: one launch of the forward kernel on x's
    device (the parameters' casts, the checks and the occupancy query run
    here, on real tensors)."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):  # a launch goes to this device
            return _launch(x, weight, bias, gamma, beta, stride, K, eps)[0]
    return _launch(x, weight, bias, gamma, beta, stride, K, eps)[0]


def _op_cpu(x, weight, bias, gamma, beta, stride, K, eps):
    """The op on the CPU: the plain version, in the kernel's output
    layout."""
    ref = dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                    stride=stride, K=K, eps=eps)
    out = _like(x, ref.shape[1])
    if ref.stride() == out.stride():
        return ref
    return out.copy_(ref)


def _op_fake(x, weight, bias, gamma, beta, stride, K, eps):
    """The op's output without data: the shape, dtype and strides the
    kernel gives (:func:`_like`)."""
    return _like(x, _out_len(x.shape[1], K, stride))


_LIB.impl("dw_conv_glob_ln", _op_cuda, "CUDA")
_LIB.impl("dw_conv_glob_ln", _op_cpu, "CPU")
torch.library.register_fake("tdanet_tpu_torch::dw_conv_glob_ln", _op_fake,
                            lib=_LIB)
OP = torch.ops.tdanet_tpu_torch.dw_conv_glob_ln.default


# the op's implementations by device: what the no-grad path runs outside
# a trace, where the dispatcher's Python kernel would add its own host
# cost to every call (5-18 us a call on the H100's host, up to 9 ms an
# eager forward of 512 sites; chip_smoke.py phase 26)
_IMPL = {"cpu": _op_cpu, "cuda": _op_cuda}


def _wants_grad(*ps):
    return torch.is_grad_enabled() and any(
        p is not None and p.requires_grad for p in ps)


def dw_conv_glob_ln(x, weight, bias, gamma, beta, *, stride=1, K=5,
                    eps=1e-8):
    """Depthwise K-tap conv, padding (K-1)//2, stride 1 or 2, + bias (or
    none), then GlobLN over each sample's (T_out, C) with fp32 statistics
    and a per-channel affine. x (B, T, C) -> (B, T_out, C).

    One of T and C must be x's innermost contiguous axis; the output has
    x's layout. Where autograd wants a gradient of any operand, the call
    goes through :class:`DwConvGlobLnFunction` (the backward kernel) on
    the card and the plain version on the CPU; elsewhere it runs the
    registered op :data:`OP`: under a trace (``torch.export``) the op
    itself, which the program keeps as one node, and eagerly the op's
    implementation for x's device, without the dispatcher's cost.
    ``launches`` counts the forward kernel's launches."""
    _check(x, weight, bias, gamma, beta, stride, K)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no dw_conv_glob_ln for device {x.device}")
    if not _wants_grad(x, weight, bias, gamma, beta):
        if torch.compiler.is_compiling():  # torch.export: one node a site
            return OP(x, weight, bias, gamma, beta, stride, K, eps)
        return _IMPL[x.device.type](x, weight, bias, gamma, beta, stride, K,
                                    eps)
    if x.device.type == "cpu":  # autograd differentiates the plain version
        return dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                         stride=stride, K=K, eps=eps)
    args = (x, weight, bias, gamma, beta, stride, K, eps)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):  # a launch goes to this device
            return DwConvGlobLnFunction.apply(*args)
    return DwConvGlobLnFunction.apply(*args)


dw_conv_glob_ln.launches = 0


def forward_with_stats(x, weight, bias, gamma, beta, *, stride=1, K=5,
                       eps=1e-8):
    """The forward and each sample's (hi, lo, rstd) (B, 3), the operands
    of :func:`dw_conv_glob_ln_backward`: the kernel's on a CUDA tensor
    (a launch it counts), the plain version's on a CPU one."""
    _check(x, weight, bias, gamma, beta, stride, K)
    if x.device.type == "cpu":
        return (dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                          stride=stride, K=K, eps=eps),
                stats_reference(x, weight, bias, stride=stride, K=K,
                                eps=eps))
    with torch.cuda.device(x.device):
        return _launch(x, weight, bias, gamma, beta, stride, K, eps,
                       want_stats=True)


def dw_conv_glob_ln_backward(dy, x, weight, bias, gamma, stats, *, stride=1,
                             K=5):
    """The gradients of :func:`dw_conv_glob_ln` at x, from the forward's
    per-sample statistics ``stats`` (B, 3) (:func:`forward_with_stats`):
    (dx, dweight, dbias or None, dgamma, dbeta). dy (B, T_out, C) must
    have the output's innermost axis (its other strides are its own). On
    a CUDA tensor it launches the backward kernel or raises; on a CPU
    tensor it computes
    :func:`dw_conv_glob_ln_backward_reference`. ``launches`` counts the
    kernel's launches."""
    _check(x, weight, bias, gamma, gamma, stride, K)
    if dy.shape != (x.shape[0], _out_len(x.shape[1], K, stride),
                    x.shape[2]) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                         f"the output of x {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return dw_conv_glob_ln_backward_reference(
            dy, x, weight, bias, gamma, stride=stride, K=K, stats=stats)
    if x.device.type != "cuda":
        raise RuntimeError(f"no dw_conv_glob_ln_backward for {x.device}")
    if x.dtype not in _STORAGE:
        raise TypeError(f"the CUDA kernel stores fp32 or bf16, got {x.dtype}")
    if dy.stride(1 if x.stride(1) == 1 else 2) != 1 or min(dy.stride()) < 0:
        raise ValueError("dy must have the forward output's innermost axis")
    with torch.cuda.device(x.device):
        return _launch_backward(dy, x, weight, bias, gamma, stats, stride, K)


dw_conv_glob_ln_backward.launches = 0


def dw_conv_glob_ln_chunked(x, weight, bias, gamma, beta, *, eps=1e-8):
    """The stride-1 form of :func:`dw_conv_glob_ln` with K taken from the
    weight, the signature of the JAX package's streamed two-pass kernel."""
    return dw_conv_glob_ln(x, weight, bias, gamma, beta, stride=1,
                           K=weight.shape[-1], eps=eps)
