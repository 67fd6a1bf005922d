"""The two halves of one UConvBlock as CUDA kernels: their wrappers, their
plain PyTorch versions, and the padded channels-last layout they share.

Counterpart of ``tdanet_tpu/kernels/uconv_block.py`` (inference only):

  pyramid_fused:      proj_1x1 (1x1 conv + GlobLN + PReLU) -> ``depth``
                      depthwise k5 conv + GlobLN stages (stride 1, then 2)
                      -> the adaptive-average-pool sum of every scale at
                      the coarsest length. ``csrc/uconv_pyramid.cu``.
  fuse_expand_fused:  per-scale LA fusion with the global feature -> the
                      top-down k5 LA expansion (its first pair takes the
                      FINER fused scale depth-3) -> res_conv + residual.
                      ``csrc/uconv_fuse_expand.cu``.

The GA transformer runs between the two in plain PyTorch.

Layout ("raw"): a scale of true length T is a (B, _pads(T), C) buffer with
its rows at PAD .. PAD+T-1 and zero rows around them; the pooled global
feature is (B, _pads(T_g) - 2*PAD, C) with its rows at 0 .. T_g-1. The
public functions take the port's ``UConvBlock`` module in place of the
JAX parameter tree; its ``state_dict`` keys are the JAX flat keys.

On a CUDA tensor a wrapper launches its kernel or raises. On a CPU tensor,
and only there, it computes the plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import _STORAGE, _as_f32
from tdanet_tpu_torch.ops import basic as ops

PAD = 8  # zero rows before and after each scale's true rows


def _pads(T):
    """Padded buffer row count for a scale with true length T."""
    return -(-T // PAD) * PAD + 2 * PAD


def scale_lengths(T0, depth):
    """True pyramid lengths: the stride-2 'same' k5 chain halves with
    ceil."""
    Ts = [T0]
    for _ in range(1, depth):
        Ts.append((Ts[-1] + 1) // 2)
    return Ts


def pool_bounds(T_in, T_out):
    """Adaptive-average-pool windows, torch semantics: output row i
    averages input rows [floor(i*T_in/T_out), ceil((i+1)*T_in/T_out)).
    Neighbouring windows overlap where T_out does not divide T_in."""
    starts = [i * T_in // T_out for i in range(T_out)]
    ends = [-(-(i + 1) * T_in // T_out) for i in range(T_out)]
    return starts, ends


def nearest_index(T_in, T_out):
    """Nearest resize T_in -> T_out: out[t] = in[floor(t*T_in/T_out)]. It
    is the LA fusion's upsample, the expansion's x2 upsample (where it
    equals t//2) and the first expansion pair's downsize."""
    return [min(t * T_in // T_out, T_in - 1) for t in range(T_out)]


def to_raw(x):
    """(B, C, T) model layout -> the padded (B, _pads(T), C) buffer."""
    B, C, T = x.shape
    out = x.new_zeros((B, _pads(T), C))
    out[:, PAD:PAD + T] = x.transpose(1, 2)
    return out


def from_raw(x_raw, T):
    """The (B, C, T) view of a padded buffer's true rows (no copy)."""
    return x_raw[:, PAD:PAD + T].transpose(1, 2)


# ---------------------------------------------------------------------------
# Weight packing: the module's parameters in the order the C entry points
# read them (counterparts of _pyramid_weight_arrays, _fusion_weight_arrays)
# ---------------------------------------------------------------------------


def _pyramid_weights(block, device):
    """proj_1x1 (weight (C, Cin, 1), bias, gamma, beta, PReLU slope), then
    per stage (taps (C, 1, 5), bias, gamma, beta), all fp32 on ``device``."""
    pj = block.proj_1x1
    prm = [pj.conv.weight, pj.conv.bias, pj.norm.gamma, pj.norm.beta,
           pj.act.weight]
    for st in block.spp_dw:
        prm += [st.conv.weight, st.conv.bias, st.norm.gamma, st.norm.beta]
    return [_as_f32(p, device) for p in prm]


def _fusion_weights(block, device):
    """Per scale the LA fusion's three k1 ConvNorms (local, global_act,
    global_embedding: weight, gamma, beta), per expansion pair the same
    three as k5 ConvNorms, then res_conv (weight (Cout, C, 1), bias), all
    fp32 on ``device``."""
    prm = []
    for la in list(block.loc_glo_fus) + list(block.last_layer):
        for cn in (la.local_embedding, la.global_act, la.global_embedding):
            prm += [cn.conv.weight, cn.norm.gamma, cn.norm.beta]
    prm += [block.res_conv.weight, block.res_conv.bias]
    return [_as_f32(p, device) for p in prm]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _conv_norm(x, cn, *, stride=1):
    """A depthwise ConvNorm module's function in plain ops (never its
    kernel): conv (padding (K-1)//2) + GlobLN."""
    conv = cn.conv
    y = ops.conv1d(x, conv.weight, conv.bias, stride=stride,
                   padding=(conv.kernel_size[0] - 1) // 2,
                   groups=conv.groups)
    return ops.glob_ln(y, cn.norm.gamma, cn.norm.beta)


def pyramid_fused_reference(x, block, *, depth, raw=False, raw_in=False,
                            T0=None):
    """Plain version of :func:`pyramid_fused`, the same arguments and
    outputs."""
    if raw_in:
        x = from_raw(x, T0)
    T0 = x.shape[-1]
    Ts = scale_lengths(T0, depth)
    pj = block.proj_1x1
    h = ops.prelu(_conv_norm(x, pj), pj.act.weight)
    scales = []
    for s in range(depth):
        h = _conv_norm(h, block.spp_dw[s], stride=1 if s == 0 else 2)
        scales.append(h)
    pooled = scales[-1]
    for fea in scales[:-1]:
        pooled = pooled + ops.adaptive_avg_pool1d(fea, Ts[-1])
    if not raw:
        return scales, pooled
    rows_g = _pads(Ts[-1]) - 2 * PAD
    pooled_raw = x.new_zeros((x.shape[0], rows_g, pooled.shape[1]))
    pooled_raw[:, :Ts[-1]] = pooled.transpose(1, 2)
    return [to_raw(s) for s in scales], pooled_raw


def _la(la, x_l, x_g):
    """LA in plain ops with index-rule resizing:
    local(x_l) * sigmoid(act(x_g))[idx] + emb(x_g)[idx]."""
    T_g, T_l = x_g.shape[-1], x_l.shape[-1]
    # nearest_index on the device: no host copy, so a CUDA graph holds it
    idx = (torch.arange(T_l, device=x_g.device) * T_g // T_l).clamp_(
        max=T_g - 1)
    sig = torch.sigmoid(_conv_norm(x_g, la.global_act))
    emb = _conv_norm(x_g, la.global_embedding)
    return _conv_norm(x_l, la.local_embedding) * sig.index_select(-1, idx) \
        + emb.index_select(-1, idx)


def fuse_expand_fused_reference(scales_raw, g_raw, x_raw, block, *, Ts):
    """Plain version of :func:`fuse_expand_fused`, the same arguments and
    output."""
    depth = len(Ts)
    scales = [from_raw(s, T) for s, T in zip(scales_raw, Ts)]
    g = g_raw[:, :Ts[-1]].transpose(1, 2)
    fused = [_la(block.loc_glo_fus[i], scales[i], g) for i in range(depth)]
    exp = None
    for i in range(depth - 2, -1, -1):
        x_g = fused[i - 1] if i == depth - 2 else exp
        exp = _la(block.last_layer[i], fused[i], x_g)
    out = ops.conv1d(exp, block.res_conv.weight, block.res_conv.bias) \
        + from_raw(x_raw, Ts[0])
    return to_raw(out)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


_MAX_T = 65535  # kMaxT of csrc/uconv_common.cuh: 32-bit index products


def _check_launch(name, tensors, block, T0):
    if T0 > _MAX_T:
        raise ValueError(f"{name}: the CUDA kernel takes T0 <= {_MAX_T}, "
                         f"got {T0}")
    if tensors[0].dtype not in _STORAGE:
        raise TypeError(f"{name}: the CUDA kernel stores fp32 or bf16, got "
                        f"{tensors[0].dtype}")
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise TypeError(f"{name}: all activations must share one dtype")
    if torch.is_grad_enabled() and (
            any(t.requires_grad for t in tensors)
            or any(p.requires_grad for p in block.parameters())):
        raise RuntimeError(f"{name} has no backward kernel; call it under "
                           "torch.inference_mode() or no_grad()")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


@lru_cache(maxsize=None)
def _library(name):
    lib = _build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scratch = getattr(lib, f"{name}_scratch")
    scratch.argtypes = [i, i, i, i]
    scratch.restype = ctypes.c_longlong
    launch = getattr(lib, f"{name}_launch")
    if name == "uconv_pyramid":
        launch.argtypes = ([p, ll, ll, ll] + [p] * 6
                           + [i] * 6 + [ctypes.c_float, p])
    else:
        launch.argtypes = ([p, p, ll, ll, ll] + [p] * 7
                           + [i] * 6 + [ctypes.c_float, p])
    launch.restype = i
    return lib


def _launch_pyramid(x, block, depth, T0, raw_in, eps):
    dev, dt = x.device, x.dtype
    B = x.shape[0]
    Cin = block.proj_1x1.conv.in_channels
    C = block.proj_1x1.conv.out_channels
    Ts = scale_lengths(T0, depth)
    if raw_in:  # (B, rows0, Cin); row t of the true data is PAD + t
        base = x.data_ptr() + PAD * x.stride(1) * x.element_size()
        xs = (x.stride(0), x.stride(1), x.stride(2))
    else:       # (B, Cin, T0)
        base = x.data_ptr()
        xs = (x.stride(0), x.stride(2), x.stride(1))
    outs = [torch.empty((B, _pads(T), C), dtype=dt, device=dev) for T in Ts]
    pooled = torch.empty((B, _pads(Ts[-1]) - 2 * PAD, C), dtype=dt,
                         device=dev)
    h0 = torch.empty((B, _pads(T0), C), dtype=dt, device=dev)
    lib = _library("uconv_pyramid")
    n_part = lib.uconv_pyramid_scratch(B, T0, C, depth)
    y_proj = torch.empty(B * T0 * C + n_part, dtype=torch.float32,
                         device=dev)
    prm = _pyramid_weights(block, dev)
    with torch.cuda.device(dev):
        err = lib.uconv_pyramid_launch(
            base, *xs, _ptrs(outs), pooled.data_ptr(), y_proj.data_ptr(),
            y_proj.data_ptr() + 4 * B * T0 * C, h0.data_ptr(), _ptrs(prm),
            B, T0, Cin, C, depth, _STORAGE[dt], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pyramid_fused launch failed: CUDA error {err}")
    pyramid_fused.launches += 1
    return outs, pooled


def _launch_fuse_expand(scales_raw, g_raw, x_raw, block, Ts, eps):
    dev, dt = x_raw.device, x_raw.dtype
    B, rows0, Cout = x_raw.shape
    C = scales_raw[0].shape[-1]
    depth = len(Ts)
    out = torch.empty_like(x_raw)
    # scratch: the depth fused scales, the depth-1 expansion outputs, then
    # a contiguous copy of g
    rows = [_pads(T) for T in Ts] + [_pads(T) for T in Ts[:-1]] + [Ts[-1]]
    work = torch.empty(B * C * sum(rows), dtype=dt, device=dev)
    bufs, off = [], 0
    for r in rows:
        bufs.append(work[off:off + B * r * C])
        off += B * r * C
    lib = _library("uconv_fuse_expand")
    partials = torch.empty(lib.uconv_fuse_expand_scratch(B, Ts[0], C, depth),
                           dtype=torch.float32, device=dev)
    prm = _fusion_weights(block, dev)
    with torch.cuda.device(dev):
        err = lib.uconv_fuse_expand_launch(
            _ptrs(scales_raw), g_raw.data_ptr(), *g_raw.stride(),
            bufs[-1].data_ptr(), x_raw.data_ptr(), out.data_ptr(),
            _ptrs(bufs[:depth]), _ptrs(bufs[depth:-1]), partials.data_ptr(),
            _ptrs(prm),
            B, Ts[0], C, Cout, depth, _STORAGE[dt], eps,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fuse_expand_fused launch failed: CUDA error {err}")
    fuse_expand_fused.launches += 1
    return out


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def _check_block(block, depth):
    if depth != block.depth:
        raise ValueError(f"depth {depth} differs from the block's "
                         f"{block.depth}")
    if depth < 3:
        raise ValueError(f"the expansion's first pair needs depth >= 3, "
                         f"got {depth}")


@lru_cache(maxsize=64)
def _check_chain(Ts):
    """Ts is a stride-2 chain, and its x2 expansion steps have the property
    they rely on, floor(t*T_{i+1}/T_i) == t//2 (once per chain: the check
    is O(T) Python)."""
    if list(Ts) != scale_lengths(Ts[0], len(Ts)):
        raise ValueError(f"Ts must be a stride-2 chain, got {list(Ts)}")
    for i in range(len(Ts) - 2):
        if nearest_index(Ts[i + 1], Ts[i]) != [t // 2 for t in range(Ts[i])]:
            raise ValueError(f"x2-repeat property fails for "
                             f"{Ts[i + 1]}->{Ts[i]}")


def pyramid_fused(x, block, *, depth, raw=False, raw_in=False, T0=None,
                  eps=1e-8):
    """Fused proj_1x1 + pyramid + pooled global feature of one UConvBlock.

    x: (B, C_out, T) block input in model layout, or with ``raw_in=True``
    an already padded (B, _pads(T0), C_out) buffer with zero pad rows.
    block: the port's ``UConvBlock`` (proj_1x1, spp_dw are read).
    Returns (scales, pooled): model layout (B, C, T_i) and (B, C, T_g),
    views of the padded buffers, or with ``raw=True`` the padded
    (B, _pads(T_i), C) buffers and the (B, rows_g, C) pooled buffer.
    ``launches`` counts the kernel's launches."""
    _check_block(block, depth)
    Cin = block.proj_1x1.conv.in_channels
    if x.ndim != 3:
        raise ValueError(f"x must be 3-D, got shape {tuple(x.shape)}")
    if raw_in:
        if T0 is None or x.shape[1] != _pads(T0) or x.shape[2] != Cin:
            raise ValueError(f"raw_in needs T0 and x of shape (B, "
                             f"_pads(T0), {Cin}); got {tuple(x.shape)}, "
                             f"T0={T0}")
    else:
        if x.shape[1] != Cin:
            raise ValueError(f"x must be (B, {Cin}, T), got "
                             f"{tuple(x.shape)}")
        T0 = x.shape[2]
    if min(x.shape[0], T0) < 1:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pyramid_fused_reference(x, block, depth=depth, raw=raw,
                                       raw_in=raw_in, T0=T0)
    if x.device.type != "cuda":
        raise RuntimeError(f"no pyramid_fused for device {x.device}")
    _check_launch("pyramid_fused", [x], block, T0)
    outs, pooled = _launch_pyramid(x, block, depth, T0, raw_in, eps)
    if raw:
        return outs, pooled
    Ts = scale_lengths(T0, depth)
    return [from_raw(o, T) for o, T in zip(outs, Ts)], \
        pooled[:, :Ts[-1]].transpose(1, 2)


pyramid_fused.launches = 0


def fuse_expand_fused(scales_raw, g_raw, x_raw, block, *, Ts, eps=1e-8):
    """Fused LA fusion + top-down expansion + res_conv of one UConvBlock.

    scales_raw: the ``depth`` padded (B, _pads(T_i), C) buffers of
    :func:`pyramid_fused` (contiguous). g_raw: the post-GA global feature,
    any (B, >= T_g, C) view (rows from T_g on are not read). x_raw: the
    padded (B, _pads(T_0), C_out) block input, contiguous. Returns the
    padded (B, _pads(T_0), C_out) block output, pad rows zero.
    ``launches`` counts the kernel's launches."""
    depth = len(Ts)
    _check_block(block, depth)
    _check_chain(tuple(Ts))
    if len(scales_raw) != depth:
        raise ValueError(f"{len(scales_raw)} scales for depth {depth}")
    B, _, C = scales_raw[0].shape
    Cout = block.res_conv.out_channels
    for s, T in zip(scales_raw, Ts):
        if tuple(s.shape) != (B, _pads(T), C) or not s.is_contiguous():
            raise ValueError(f"scale of length {T} must be a contiguous "
                             f"({B}, {_pads(T)}, {C}), got "
                             f"{tuple(s.shape)} strides {s.stride()}")
    if g_raw.ndim != 3 or g_raw.shape[0] != B or g_raw.shape[1] < Ts[-1] \
            or g_raw.shape[2] != C:
        raise ValueError(f"g_raw must be ({B}, >= {Ts[-1]}, {C}), got "
                         f"{tuple(g_raw.shape)}")
    if tuple(x_raw.shape) != (B, _pads(Ts[0]), Cout) \
            or not x_raw.is_contiguous():
        raise ValueError(f"x_raw must be a contiguous ({B}, {_pads(Ts[0])}, "
                         f"{Cout}), got {tuple(x_raw.shape)}")
    if C != block.res_conv.in_channels:
        raise ValueError(f"{C} channels for a block of "
                         f"{block.res_conv.in_channels}")
    if x_raw.device.type == "cpu":
        return fuse_expand_fused_reference(scales_raw, g_raw, x_raw, block,
                                           Ts=Ts)
    if x_raw.device.type != "cuda":
        raise RuntimeError(f"no fuse_expand_fused for device {x_raw.device}")
    _check_launch("fuse_expand_fused", [x_raw, g_raw, *scales_raw], block,
                  Ts[0])
    return _launch_fuse_expand(scales_raw, g_raw, x_raw, block, Ts, eps)


fuse_expand_fused.launches = 0
