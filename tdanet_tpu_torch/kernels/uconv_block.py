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
and only there, it computes the plain version. The CUDA kernels take
channel counts that are multiples of 64 and operands on 16-byte
boundaries; the wrappers raise on the rest. Each block keeps its
parameters packed as the kernels read them (:func:`weight_pack`), rebuilt
only when a parameter changes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from tdanet_tpu_torch.kernels import _build
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import _STORAGE
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
# Weight packing: the module's parameters in the layout the C entry points
# read (the Params structs of csrc/uconv_pyramid.cu, uconv_fuse_expand.cu):
# one fp32 pack of the small parameters, depthwise taps tap-major (5, C),
# and the 1x1 product's weight transposed to (K, N) in the storage type.
# ---------------------------------------------------------------------------


def _taps(conv):
    """A depthwise conv weight (C, 1, K) as (K, C)."""
    return conv.weight[:, 0, :].t()


def _pyramid_pack(block):
    """proj_1x1 (bias, gamma, beta, PReLU slope padded to 4), then per stage
    (taps (5, C), bias, gamma, beta); the proj weight as (Cin, C)."""
    pj = block.proj_1x1
    prm = [pj.conv.bias, pj.norm.gamma, pj.norm.beta,
           F.pad(pj.act.weight.reshape(-1), (0, 3))]
    for st in block.spp_dw:
        prm += [_taps(st.conv), st.conv.bias, st.norm.gamma, st.norm.beta]
    return prm, pj.conv.weight[:, :, 0].t()


def _fusion_pack(block):
    """Per fusion LA the local, global_act and global_embedding k1
    ConvNorms (weight, gamma, beta), per expansion pair the same three k5
    ConvNorms (taps (5, C), gamma, beta), then res_conv's bias; res_conv's
    weight as (C, Cout)."""
    prm = []
    for la in block.loc_glo_fus:
        for cn in (la.local_embedding, la.global_act, la.global_embedding):
            prm += [cn.conv.weight, cn.norm.gamma, cn.norm.beta]
    for la in block.last_layer:
        for cn in (la.local_embedding, la.global_act, la.global_embedding):
            prm += [_taps(cn.conv), cn.norm.gamma, cn.norm.beta]
    prm.append(block.res_conv.bias)
    return prm, block.res_conv.weight[:, :, 0].t()


_PACKERS = {"pyramid": (_pyramid_pack, lambda b: [
                b.proj_1x1.conv.weight, b.proj_1x1.conv.bias,
                b.proj_1x1.norm.gamma, b.proj_1x1.norm.beta,
                b.proj_1x1.act.weight, *b.spp_dw.parameters()]),
            "fusion": (_fusion_pack, lambda b: [
                *b.loc_glo_fus.parameters(), *b.last_layer.parameters(),
                *b.res_conv.parameters()])}


def _version(t):
    """A tensor's version counter; inference tensors keep none (-1): their
    pack is keyed on the address alone."""
    return -1 if t.is_inference() else t._version


class _Pack:
    """A block half's parameters as its kernel reads them, and the source
    tensors they were made from (held, so no address is reused while the
    pack lives)."""

    def __init__(self, kind, block, dtype, device):
        pack, params = _PACKERS[kind]
        self.kind = kind
        self.sources = [p.detach() for p in params(block)]
        self.versions = [_version(p) for p in self.sources]
        self.dtype, self.device = dtype, device
        with torch.no_grad():
            small, wt = pack(block)
            self.prm = torch.cat([p.detach().reshape(-1).to(device,
                                                             torch.float32)
                                  for p in small])
            self.wt = wt.detach().to(device, dtype).contiguous()
        self.prm_ptr, self.wt_ptr = self.prm.data_ptr(), self.wt.data_ptr()

    def current(self, block, dtype, device):
        """Whether the pack still holds the block's parameters: the same
        tensors (address) at the same version (no in-place update since)."""
        _, params = _PACKERS[self.kind]
        ps = params(block)
        return (dtype == self.dtype and device == self.device
                and len(ps) == len(self.sources)
                and all(p.data_ptr() == s.data_ptr() and _version(p) == v
                        for p, s, v in zip(ps, self.sources, self.versions)))


def weight_pack(kind, block, dtype, device):
    """The block's pack for one half ("pyramid" or "fusion"), made once and
    reused while its parameters are unchanged (keyed on each tensor's
    address and version: an in-place update or a ``.to()`` rebuilds it)."""
    packs = block.__dict__.setdefault("_kernel_packs", {})
    pack = packs.get(kind)
    if pack is None or not pack.current(block, dtype, device):
        pack = packs[kind] = _Pack(kind, block, dtype, device)
    return pack


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
def kernels_per_call(depth):
    """Device kernels one call of either half launches, after one memset:
    the product and depth + 1 passes (uconv_pyramid.cu); the k1
    statistics, the fusion, depth - 1 expansion pairs and res_conv
    (uconv_fuse_expand.cu)."""
    return depth + 2


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


_MMA_W_BYTES = 128 * 1024  # kMmaWBytes of csrc/uconv_gemm.cuh


def check_product(name, K, N):
    """The bf16 1x1 products keep the whole (K, N) weight in one SM's
    shared memory and multiply 128 or 256 columns at a time
    (``mma_fits`` of csrc/uconv_gemm.cuh). Raises ValueError."""
    n = 256 if N >= 256 else 128
    if (N >= 256 and N % 256) or -(-N // n) * n * K * 2 > _MMA_W_BYTES:
        raise ValueError(f"{name}: the bf16 tensor-core product takes N "
                         f"below 256 or a multiple of 256 and a weight of "
                         f"at most {_MMA_W_BYTES} bytes; got K={K}, N={N}")


def check_kernel_operands(name, channels, aligned=(), strides=()):
    """What the CUDA kernels need beyond the plain version: channel counts
    that are multiples of 64 (64-channel tiles, 64-deep product slices),
    and 16-byte alignment of every operand read as vectors or through a
    tensor map: ``aligned`` holds (what, tensor or byte address), ``strides``
    (what, stride in elements, element size). Raises ValueError."""
    for what, n in channels:
        if n < 64 or n % 64:
            raise ValueError(f"{name}: the CUDA kernel takes {what} that are "
                             f"multiples of 64, got {n}")
    for what, t in aligned:
        addr = t if isinstance(t, int) else t.data_ptr()
        if addr % 16:
            raise ValueError(f"{name}: {what} must start on a 16-byte "
                             f"boundary (vector loads, tensor maps)")
    for what, stride, size in strides:
        if stride * size % 16:
            raise ValueError(f"{name}: the {what} stride of {stride} "
                             f"elements is not a multiple of 16 bytes")


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


@lru_cache(maxsize=None)
def _library(name):
    lib = _build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    params = getattr(lib, f"{name}_params")
    params.restype = ll
    scratch = getattr(lib, f"{name}_scratch")
    scratch.restype = ll
    launch = getattr(lib, f"{name}_launch")
    if name == "uconv_pyramid":
        params.argtypes = [i, i]
        scratch.argtypes = [i, i, i, i, i]
        launch.argtypes = ([p, ll, ll] + [p] * 6 + [i] * 6
                           + [ctypes.c_float, p])
    else:
        params.argtypes = [i, i, i]
        scratch.argtypes = [i, i, i, i]
        launch.argtypes = ([p, p, ll, ll, ll] + [p] * 8 + [i] * 6
                           + [ctypes.c_float, p])
    launch.restype = i
    return lib


def _views(work, shapes):
    """Contiguous views of one buffer, in order."""
    out, off = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(work[off:off + n].view(shape))
        off += n
    return out


def pyramid_operand(x, raw_in, T0, Cin, C):
    """The projection's operand as the kernel reads it: (x to keep alive,
    the byte address of its first true row, its sample and row strides in
    elements). A model-layout (B, Cin, T0) x is copied to (B, T0, Cin):
    the product reads rows of channels. Raises where the kernel cannot
    read it (see :func:`check_kernel_operands`)."""
    if raw_in:  # (B, rows0, Cin); row t of the true data is PAD + t
        if x.stride(2) != 1:
            raise ValueError("pyramid_fused: the CUDA kernel reads x's rows "
                             "in place; channels must be contiguous, got "
                             f"strides {x.stride()}")
        xs = (x.stride(0), x.stride(1))
        base = x.data_ptr() + PAD * x.stride(1) * x.element_size()
    else:
        x = x.transpose(1, 2).contiguous()
        xs, base = (T0 * Cin, Cin), x.data_ptr()
    esize = x.element_size()
    check_kernel_operands(
        "pyramid_fused", [("C_out", Cin), ("C", C)], [("x", base)],
        [("sample", xs[0], esize), ("row", xs[1], esize)])
    if x.dtype == torch.bfloat16:
        check_product("pyramid_fused", Cin, C)
    return x, base, xs


def fuse_expand_operands(scales_raw, x_raw, C, Cout):
    """Raises where the kernel cannot read the operands of
    :func:`fuse_expand_fused` (see :func:`check_kernel_operands`)."""
    check_kernel_operands(
        "fuse_expand_fused", [("C", C), ("C_out", Cout)],
        [("x_raw", x_raw)] + [(f"scale {i}", s)
                              for i, s in enumerate(scales_raw)])
    if x_raw.dtype == torch.bfloat16:
        check_product("fuse_expand_fused", C, Cout)


def _launch_pyramid(x, block, depth, T0, raw_in, eps):
    dev, dt = x.device, x.dtype
    B = x.shape[0]
    Cin = block.proj_1x1.conv.in_channels
    C = block.proj_1x1.conv.out_channels
    Ts = scale_lengths(T0, depth)
    x, base, xs = pyramid_operand(x, raw_in, T0, Cin, C)
    rows_g = _pads(Ts[-1]) - 2 * PAD
    shapes = [(B, _pads(T), C) for T in Ts] + [(B, rows_g, C), (B, T0, C)]
    work = torch.empty(sum(a * b * c for a, b, c in shapes), dtype=dt,
                       device=dev)
    *outs, pooled, y = _views(work, shapes)
    lib = _library("uconv_pyramid")
    bf16 = _STORAGE[dt]
    scratch = torch.empty(lib.uconv_pyramid_scratch(B, T0, C, depth, bf16),
                          dtype=torch.float32, device=dev)
    pack = weight_pack("pyramid", block, dt, dev)
    if pack.prm.numel() != lib.uconv_pyramid_params(C, depth):
        raise RuntimeError("pyramid_fused: parameter pack of "
                           f"{pack.prm.numel()} floats, the kernel reads "
                           f"{lib.uconv_pyramid_params(C, depth)}")
    with torch.cuda.device(dev):
        err = lib.uconv_pyramid_launch(
            base, *xs, _ptrs(outs), pooled.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), pack.prm_ptr, pack.wt_ptr,
            B, T0, Cin, C, depth, bf16, eps,
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
    fuse_expand_operands(scales_raw, x_raw, C, Cout)
    out = torch.empty_like(x_raw)
    # scratch: the depth fused scales, the depth-1 expansion outputs, then
    # a contiguous copy of g
    shapes = [(B, _pads(T), C) for T in Ts] \
        + [(B, _pads(T), C) for T in Ts[:-1]] + [(B, Ts[-1], C)]
    work = torch.empty(sum(a * b * c for a, b, c in shapes), dtype=dt,
                       device=dev)
    bufs = _views(work, shapes)
    lib = _library("uconv_fuse_expand")
    scratch = torch.empty(lib.uconv_fuse_expand_scratch(B, Ts[0], C, depth),
                          dtype=torch.float32, device=dev)
    pack = weight_pack("fusion", block, dt, dev)
    if pack.prm.numel() != lib.uconv_fuse_expand_params(C, Cout, depth):
        raise RuntimeError("fuse_expand_fused: parameter pack of "
                           f"{pack.prm.numel()} floats, the kernel reads "
                           f"{lib.uconv_fuse_expand_params(C, Cout, depth)}")
    with torch.cuda.device(dev):
        err = lib.uconv_fuse_expand_launch(
            _ptrs(scales_raw), g_raw.data_ptr(), *g_raw.stride(),
            bufs[-1].data_ptr(), x_raw.data_ptr(), out.data_ptr(),
            _ptrs(bufs[:depth]), _ptrs(bufs[depth:-1]), scratch.data_ptr(),
            pack.prm_ptr, pack.wt_ptr,
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
