"""The port's fused UConvBlock halves against the JAX package.

The plain versions (what the wrappers compute on a CPU tensor) are held
against the Pallas kernels of ``tdanet_tpu/kernels/uconv_block.py`` in
interpret mode, as ``tests/test_uconv_kernel.py`` runs them, at that
suite's sizes and tolerances; the fused block (pyramid_fused -> GA ->
fuse_expand_fused) against the JAX module block in float64. The CUDA
kernels are held against their plain versions on a card only:
    python -m pytest --noconftest tests/test_torch_uconv_kernel.py -m gpu

JAX is imported inside the tests that need it, so the card's test also
runs where JAX is absent.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tdanet_tpu_torch.kernels.uconv_block import (
    PAD, _pads, from_raw, fuse_expand_fused, fuse_expand_fused_reference,
    fuse_expand_operands, nearest_index, pool_bounds, pyramid_fused,
    pyramid_fused_reference, pyramid_operand, scale_lengths, to_raw,
    weight_pack)
from tdanet_tpu_torch.models import load_jax_params
from tdanet_tpu_torch.models.components import UConvBlock
from tdanet_tpu_torch.probes.hybrid import hybrid_block
from tdanet_tpu_torch.probes.uconv_kernel import (
    fused_block, fused_block_raw, seeded_block)

from torch_port_helpers import perturb_flat

B, COUT, C = 2, 64, 128
CASES = [(402, 5), (201, 4)]  # the JAX suite's (T, depth)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: parallel test workers would otherwise
    oversubscribe the cores (each op's parallel region waiting for threads
    the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_pair(depth, seed):
    """(JAX block, JAX f32 params, port block fp32) on the same perturbed
    weights."""
    import jax
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu.models.components import UConvBlock as JaxUConvBlock
    jblk = JaxUConvBlock(out_channels=COUT, in_channels=C,
                         upsampling_depth=depth)
    flat = perturb_flat(pytree_to_flat_torch(
        jblk.init(jax.random.PRNGKey(seed))), seed)
    block = load_jax_params(UConvBlock(COUT, C, depth), flat).eval()
    return jblk, flat_torch_to_pytree(flat), block, flat


def _x(T, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, COUT, T)) \
        .astype(dtype)


def _np_raw(x):
    """numpy (B, C, T) -> padded (B, _pads(T), C)."""
    T = x.shape[-1]
    out = np.zeros((x.shape[0], _pads(T), x.shape[1]), x.dtype)
    out[:, PAD:PAD + T] = np.swapaxes(x, 1, 2)
    return out


def _assert_pads_zero(raw, T, offset=PAD):
    """Every row outside [offset, offset + T) is exactly zero."""
    raw = torch.as_tensor(np.asarray(raw))
    assert torch.all(raw[:, :offset] == 0)
    assert torch.all(raw[:, offset + T:] == 0)


# ---------------------------------------------------------------------------
# Index rules and layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T0,depth", [(2010, 5), (402, 5), (201, 4)])
def test_index_rules_match_torch(T0, depth):
    Ts = scale_lengths(T0, depth)
    assert Ts == [T0] + [(t + 1) // 2 for t in Ts[:-1]]
    for T in Ts[:-1]:  # the pool is adaptive_avg_pool1d's window rule
        starts, ends = pool_bounds(T, Ts[-1])
        x = torch.arange(T, dtype=torch.float64)[None, None]
        want = F.adaptive_avg_pool1d(x, Ts[-1])[0, 0]
        got = torch.tensor([(s + e - 1) / 2 for s, e in zip(starts, ends)],
                           dtype=torch.float64)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    pairs = [(Ts[-1], T) for T in Ts] + [(Ts[depth - 3], Ts[depth - 2])] \
        + [(Ts[i + 1], Ts[i]) for i in range(depth - 2)]
    for T_in, T_out in pairs:  # fusion upsample, quirk downsize, x2 steps
        x = torch.arange(T_in, dtype=torch.float32)[None, None]
        want = F.interpolate(x, size=T_out, mode="nearest")[0, 0].long()
        assert nearest_index(T_in, T_out) == want.tolist()
    for i in range(depth - 2):
        assert nearest_index(Ts[i + 1], Ts[i]) == \
            [t // 2 for t in range(Ts[i])]


def test_raw_layout_round_trip():
    x = torch.randn(2, 3, 21, dtype=torch.float64)
    raw = to_raw(x)
    assert raw.shape == (2, _pads(21), 3) == (2, 40, 3)
    _assert_pads_zero(raw, 21)
    assert torch.equal(from_raw(raw, 21), x)


# ---------------------------------------------------------------------------
# Plain versions against the Pallas kernels (interpret mode), f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,depth", CASES)
@pytest.mark.parametrize("layout", ["model", "raw", "raw_in"])
def test_pyramid_reference_matches_pallas(T, depth, layout):
    from tdanet_tpu.kernels import uconv_block as uk
    _, params, block, _ = _jax_pair(depth, seed=depth)
    x = _x(T, seed=T)
    raw, raw_in = layout != "model", layout == "raw_in"
    xin = _np_raw(x) if raw_in else x
    want_s, want_g = uk.pyramid_fused(xin, params, depth=depth, raw=raw,
                                      raw_in=raw_in, T0=T)
    with torch.inference_mode():
        got_s, got_g = pyramid_fused_reference(
            torch.from_numpy(xin), block, depth=depth, raw=raw,
            raw_in=raw_in, T0=T)
    assert len(got_s) == depth
    for want, got in zip(list(want_s) + [want_g], got_s + [got_g]):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-4)
    if raw:
        for got, Ts in zip(got_s, scale_lengths(T, depth)):
            _assert_pads_zero(got, Ts)
        _assert_pads_zero(got_g, scale_lengths(T, depth)[-1], offset=0)


@pytest.mark.parametrize("T,depth", CASES)
def test_fuse_expand_reference_matches_pallas(T, depth):
    """After JAX's pyramid kernel and GA, as tests/test_uconv_kernel.py
    chains them."""
    import jax.numpy as jnp
    from tdanet_tpu.kernels import uconv_block as uk
    jblk, params, block, _ = _jax_pair(depth, seed=10 + depth)
    x = _x(T, seed=T + 1)
    Ts = scale_lengths(T, depth)
    scales_raw, g_raw = uk.pyramid_fused(x, params, depth=depth, raw=True)
    g = jblk.globalatt.apply(params["globalatt"],
                             jnp.swapaxes(g_raw[:, :Ts[-1]], 1, 2))
    g_raw = jnp.pad(jnp.swapaxes(g, 1, 2),
                    ((0, 0), (0, g_raw.shape[1] - Ts[-1]), (0, 0)))
    x_raw = _np_raw(x)
    want = np.asarray(uk.fuse_expand_fused(scales_raw, g_raw, x_raw, params,
                                           Ts=Ts))
    with torch.inference_mode():
        got = fuse_expand_fused_reference(
            [torch.from_numpy(np.array(s)) for s in scales_raw],
            torch.from_numpy(np.array(g_raw)), torch.from_numpy(x_raw),
            block, Ts=Ts).numpy()
    assert got.shape == want.shape == (B, _pads(T), COUT)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    _assert_pads_zero(got, T)


def test_raw_outputs_keep_zero_pads():
    """Nonzero GlobLN shifts everywhere: a pad row that took the affine
    would be beta, not zero. The wrappers' CPU path, both halves."""
    block = seeded_block(COUT, C, 5, seed=3).double()
    assert all(block.spp_dw[s].norm.beta.abs().min() > 0 for s in range(5))
    T = 101
    Ts = scale_lengths(T, 5)
    x_raw = to_raw(torch.from_numpy(_x(T, seed=4, dtype=np.float64)))
    with torch.inference_mode():
        scales, pooled = pyramid_fused(x_raw, block, depth=5, raw=True,
                                       raw_in=True, T0=T)
        out = fuse_expand_fused(scales, pooled, x_raw, block, Ts=Ts)
    for s, Ti in zip(scales, Ts):
        assert s.shape == (B, _pads(Ti), C)
        _assert_pads_zero(s, Ti)
    assert pooled.shape == (B, _pads(Ts[-1]) - 2 * PAD, C)
    _assert_pads_zero(pooled, Ts[-1], offset=0)
    _assert_pads_zero(out, T)


# ---------------------------------------------------------------------------
# The fused block in float64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,depth", CASES)
def test_fused_block_matches_jax_module_fp64(T, depth):
    import jax
    import jax.numpy as jnp
    jblk, _, _, flat = _jax_pair(depth, seed=20 + depth)
    block = load_jax_params(UConvBlock(COUT, C, depth).double(), flat)
    x = _x(T, seed=T + 2, dtype=np.float64)
    from tdanet_tpu.models import flat_torch_to_pytree
    with jax.enable_x64():
        p64 = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        want = np.asarray(jax.jit(jblk.apply)(p64, jnp.asarray(x)))
    assert want.dtype == np.float64
    before = (pyramid_fused.launches, fuse_expand_fused.launches)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        got = fused_block(block, xt)
        module = block(xt)
    assert (pyramid_fused.launches, fuse_expand_fused.launches) == before
    assert got.dtype == torch.float64 and got.shape == (B, COUT, T)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                               atol=1e-10 * scale)
    torch.testing.assert_close(got, module, rtol=1e-10, atol=1e-10 * scale)


def test_fused_block_per_utterance_rows_equal_single_rows():
    block = seeded_block(COUT, C, 4, seed=5).double()
    x = torch.from_numpy(_x(101, seed=6, dtype=np.float64))
    x = torch.cat([x, x.flip(0)])  # 4 rows
    with torch.inference_mode():
        batched = from_raw(fused_block_raw(block, to_raw(x), 101,
                                           per_utterance=True), 101)
        for i in range(4):
            torch.testing.assert_close(batched[i:i + 1],
                                       block(x[i:i + 1]), rtol=1e-10,
                                       atol=1e-10)


def test_hybrid_block_matches_module_fp64():
    block = seeded_block(COUT, C, 5, seed=7).double()
    x = torch.from_numpy(_x(201, seed=8, dtype=np.float64))
    with torch.inference_mode():
        torch.testing.assert_close(hybrid_block(block, x), block(x),
                                   rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# What the wrappers refuse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["channels", "raw_rows", "no_T0", "depth",
                                 "shallow", "scale_shape", "strided_scale",
                                 "Ts", "g_rows", "x_raw", "narrow_channels",
                                 "misaligned_x", "row_stride",
                                 "strided_channels", "misaligned_scale",
                                 "narrow_out", "wide_product"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    block = seeded_block(8, 16, 4, seed=9)
    T = 37
    Ts = scale_lengths(T, 4)
    x = torch.randn(1, 8, T)
    x_raw = to_raw(x)
    # what only the CUDA kernels refuse: channel counts off the 64-wide
    # tiles, and operands off the 16-byte alignment of vectors and tensor
    # maps (the helpers the CUDA path runs, here on CPU tensors)
    rows = _pads(T)
    if bad == "narrow_channels":
        with pytest.raises(ValueError, match="multiples of 64"):
            pyramid_operand(torch.zeros(1, rows, 40), True, T, 40, 128)
        return
    if bad == "misaligned_x":
        x = torch.zeros(1 + rows * 64)[1:].view(1, rows, 64)
        with pytest.raises(ValueError, match="16-byte boundary"):
            pyramid_operand(x, True, T, 64, 128)
        return
    if bad == "row_stride":
        x = torch.zeros(2, rows, 66)[:, :, :64]
        with pytest.raises(ValueError, match="not a multiple of 16 bytes"):
            pyramid_operand(x, True, T, 64, 128)
        return
    if bad == "strided_channels":
        x = torch.zeros(1, 64, rows).transpose(1, 2)
        with pytest.raises(ValueError, match="channels must be contiguous"):
            pyramid_operand(x, True, T, 64, 128)
        return
    if bad == "wide_product":  # the bf16 product's weight and columns
        x = torch.zeros(1, rows, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="tensor-core product"):
            pyramid_operand(x, True, T, 64, 320)
        scales = [torch.zeros(1, _pads(t), 1024, dtype=torch.bfloat16)
                  for t in Ts]
        with pytest.raises(ValueError, match="tensor-core product"):
            fuse_expand_operands(scales, torch.zeros(
                1, rows, 128, dtype=torch.bfloat16), 1024, 128)
        return
    if bad in ("misaligned_scale", "narrow_out"):
        scales = [torch.zeros(1, _pads(t), 128) for t in Ts]
        xr = torch.zeros(1, rows, 64 if bad == "misaligned_scale" else 96)
        if bad == "misaligned_scale":
            scales[2] = torch.zeros(1 + scales[2].numel())[1:].view(
                scales[2].shape)
        with pytest.raises(ValueError, match="16-byte boundary|multiples"):
            fuse_expand_operands(scales, xr, 128, xr.shape[2])
        return
    if bad in ("channels", "raw_rows", "no_T0", "depth", "shallow"):
        kw = dict(depth=4)
        if bad == "channels":
            x = torch.randn(1, 9, T)
        elif bad == "raw_rows":
            x, kw = x_raw[:, 1:], dict(kw, raw_in=True, T0=T)
        elif bad == "no_T0":
            x, kw = x_raw, dict(kw, raw_in=True)
        elif bad == "depth":
            kw["depth"] = 5
        else:
            block = seeded_block(8, 16, 2, seed=9)
            kw["depth"] = 2
        with pytest.raises(ValueError):
            pyramid_fused(x, block, **kw)
        return
    scales, g = pyramid_fused(x_raw, block, depth=4, raw=True, raw_in=True,
                              T0=T)
    if bad == "scale_shape":
        scales[1] = scales[1][:, :-8]
    elif bad == "strided_scale":
        scales[0] = scales[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "Ts":
        Ts = [T, 19, 10, 6]
    elif bad == "g_rows":
        g = g[:, :Ts[-1] - 1]
    else:
        x_raw = x_raw[:, :, :4]
    with pytest.raises(ValueError):
        fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)


def test_model_layout_operand_is_copied_to_rows():
    """A model-layout x is handed to the product as (B, T0, Cin) rows."""
    x = torch.randn(2, 64, 37)
    xt, base, strides = pyramid_operand(x, False, 37, 64, 128)
    assert torch.equal(xt, x.transpose(1, 2)) and xt.is_contiguous()
    assert (base, strides) == (xt.data_ptr(), (37 * 64, 64))
    raw = to_raw(x)
    same, base, strides = pyramid_operand(raw, True, 37, 64, 128)
    assert same is raw and strides == (_pads(37) * 64, 64)
    assert base == raw.data_ptr() + PAD * 64 * 4


@pytest.mark.parametrize("kind", ["pyramid", "fusion"])
def test_weight_pack_is_reused_until_the_parameters_change(kind):
    """The pack is made once and reused while the parameters are the same
    tensors at the same version; an in-place update or a .to() rebuilds
    it, and its layout is the one the C entry points read."""
    block = seeded_block(64, 128, 4, seed=12)
    cpu = torch.device("cpu")
    pack = weight_pack(kind, block, torch.float32, cpu)
    assert weight_pack(kind, block, torch.float32, cpu) is pack
    assert weight_pack(kind, block, torch.bfloat16, cpu) is not pack
    pack = weight_pack(kind, block, torch.float32, cpu)
    C, Cout, depth = 128, 64, 4
    if kind == "pyramid":
        assert pack.prm.numel() == 3 * C + 4 + 8 * C * depth
        assert torch.equal(pack.wt, block.proj_1x1.conv.weight[:, :, 0].t())
        st = block.spp_dw[2]
        off = 3 * C + 4 + 2 * 8 * C
        assert torch.equal(pack.prm[3 * C], block.proj_1x1.act.weight[0])
        assert torch.equal(pack.prm[off:off + 5 * C].view(5, C),
                           st.conv.weight[:, 0, :].t())
        assert torch.equal(pack.prm[off + 7 * C:off + 8 * C], st.norm.beta)
        target = block.spp_dw[1].norm.gamma
    else:
        assert pack.prm.numel() == 9 * C * depth + 21 * C * (depth - 1) + Cout
        assert torch.equal(pack.wt, block.res_conv.weight[:, :, 0].t())
        la = block.last_layer[1].global_act
        off = 9 * C * depth + 21 * C + 7 * C
        assert torch.equal(pack.prm[off:off + 5 * C].view(5, C),
                           la.conv.weight[:, 0, :].t())
        assert torch.equal(pack.prm[-Cout:], block.res_conv.bias)
        target = block.loc_glo_fus[2].global_embedding.norm.gamma
    with torch.no_grad():
        target.mul_(2.0)
    rebuilt = weight_pack(kind, block, torch.float32, cpu)
    assert rebuilt is not pack
    assert weight_pack(kind, block, torch.float32, cpu) is rebuilt
    block.to(torch.float64)
    assert weight_pack(kind, block, torch.float32, cpu) is not rebuilt
    with torch.inference_mode():  # inference tensors keep no version
        made = seeded_block(64, 128, 4, seed=12)
        pack = weight_pack(kind, made, torch.float32, cpu)
        assert weight_pack(kind, made, torch.float32, cpu) is pack


def test_statistics_merge_keeps_fp32_at_an_offset():
    """The kernels' GlobLN statistics in fp32, mirrored in their order: per
    128 x 64 tile one reduction of sums about the tile's first value y0
    (count, y0 + s1 / n, s2 - s1 * s1 / n), parts merged by Chan's update,
    lane i of one warp taking parts i, i + 32, ..., then a shuffle tree.
    Held against float64 at an offset of 1e3, where a one-pass
    E[y^2] - E[y]^2 in fp32 is off by far more."""
    rng = np.random.default_rng(13)
    y = (1e3 + rng.standard_normal((2032, 512))).astype(np.float32)
    parts = []
    for t0 in range(0, 2032, 128):
        for c0 in range(0, 512, 64):
            tile = y[t0:t0 + 128, c0:c0 + 64]
            y0 = tile[0, 0]
            d = tile - y0
            s1 = d.sum(dtype=np.float32)
            s2 = np.square(d, dtype=np.float32).sum(dtype=np.float32)
            n = np.float32(tile.size)
            m = np.float32(s1 / n)
            parts.append((n, np.float32(y0 + m),
                          np.float32(max(s2 - s1 * m, 0))))

    def merge(a, b):
        if b[0] == 0:
            return a
        if a[0] == 0:
            return b
        n = np.float32(a[0] + b[0])
        d = np.float32(b[1] - a[1])
        mean = np.float32(a[1] + d * np.float32(b[0] / n))
        m2 = np.float32(a[2] + b[2] + d * d * np.float32(a[0] / n) * b[0])
        return (n, mean, m2)

    zero = (np.float32(0), np.float32(0), np.float32(0))
    lanes = [zero] * 32
    for i, p in enumerate(parts):
        lanes[i % 32] = merge(lanes[i % 32], p)
    h = 16
    while h:  # shuffle down: lane i takes lane i + h
        lanes = [merge(lanes[i], lanes[i + h]) if i + h < 32 else lanes[i]
                 for i in range(32)]
        h //= 2
    n, mean, m2 = lanes[0]
    y64 = y.astype(np.float64)
    assert n == y.size
    assert abs(mean - y64.mean()) <= 1e-7 * 1e3
    assert abs(m2 / n - y64.var()) <= 1e-5 * y64.var()
    one_pass = np.float32((y * y).mean(dtype=np.float32)) - np.float32(
        y.mean(dtype=np.float32)) ** 2
    assert abs(one_pass - y64.var()) > 1e-3


def test_cpu_call_counts_no_launch():
    block = seeded_block(8, 16, 3, seed=11)
    x = torch.randn(2, 8, 29)
    before = (pyramid_fused.launches, fuse_expand_fused.launches)
    with torch.inference_mode():
        fused_block(block, x)
    assert (pyramid_fused.launches, fuse_expand_fused.launches) == before


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Small widths, the bench's full width at B 24 in bf16, and a ragged
    length; every output with its pad rows; a second run equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for Bc, cout, c, T, depth, dtype in [
            (B, COUT, C, 402, 5, torch.float32),
            (B, COUT, C, 201, 4, torch.float32),
            (B, COUT, C, 2010, 5, torch.bfloat16),
            (24, 128, 512, 2010, 5, torch.bfloat16),
            (3, 128, 512, 1999, 5, torch.float32)]:
        block = seeded_block(cout, c, depth, seed=T).cuda()
        Ts = scale_lengths(T, depth)
        x = torch.from_numpy(np.random.default_rng(T).standard_normal(
            (Bc, cout, T)).astype(np.float32)).cuda().to(dtype)
        x_raw = to_raw(x)
        before = (pyramid_fused.launches, fuse_expand_fused.launches)
        with torch.inference_mode():
            got_s, got_g = pyramid_fused(x_raw, block, depth=depth, raw=True,
                                         raw_in=True, T0=T)
            again_s, again_g = pyramid_fused(x_raw, block, depth=depth,
                                             raw=True, raw_in=True, T0=T)
            ref_s, ref_g = pyramid_fused_reference(
                x_raw.float(), block, depth=depth, raw=True, raw_in=True,
                T0=T)
            scales = [s.to(dtype) for s in ref_s]
            g = ref_g.to(dtype)
            got = fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)
            again = fuse_expand_fused(scales, g, x_raw, block, Ts=Ts)
            ref = fuse_expand_fused_reference(
                [s.float() for s in scales], g.float(), x_raw.float(), block,
                Ts=Ts)
        torch.cuda.synchronize()
        assert (pyramid_fused.launches, fuse_expand_fused.launches) == \
            (before[0] + 2, before[1] + 2)
        for a, a2 in zip(got_s + [got_g, got], again_s + [again_g, again]):
            assert torch.equal(a, a2), (T, Bc, dtype)
        for a, b in zip(got_s + [got_g, got], ref_s + [ref_g, ref]):
            assert a.shape == b.shape and a.dtype == dtype
            if dtype == torch.float32:
                err = (a - b).abs().max().item()
                assert err <= 2e-3 * b.abs().max().item(), (T, err)
            else:
                snr = 10 * torch.log10(b.square().sum()
                                       / (a.float() - b).square().sum())
                assert snr.item() >= 30, (T, snr.item())
