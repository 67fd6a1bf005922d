"""The fused depthwise conv + GlobLN of the port against the JAX package's
Pallas kernels (interpret mode off TPU, as tests/test_fused_pyramid.py
runs them); the CUDA kernel's tile and grid plan and, mirrored in fp32 in
its own order, its merge of the statistics; and the CUDA kernel against
its plain version on a card.

JAX is imported inside the tests that need it, so the CUDA test also runs
where JAX is absent:
    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""
import numpy as np
import pytest
import torch

from tdanet_tpu_torch.kernels import dw_conv_glob_ln as dw
from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_chunked, dw_conv_glob_ln_reference)
from tdanet_tpu_torch.probes.dw_sites import SCALES, VARIANTS, block_sites

# the JAX fused-pyramid suite's own tolerance (fp32)
RTOL, ATOL = 1e-4, 1e-5


def _inputs(B, T, C, K, bias, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((C, 1, K)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(C) * 0.1).astype(np.float32) if bias \
        else np.zeros(C, np.float32)
    g = rng.standard_normal(C).astype(np.float32)
    be = rng.standard_normal(C).astype(np.float32)
    return x, w, b, g, be


def _torch(arrs, bias):
    x, w, b, g, be = (torch.from_numpy(a) for a in arrs)
    return x, w, (b if bias else None), g, be


@pytest.mark.parametrize("T,stride,K,bias", [
    (64, 1, 5, True), (65, 1, 5, True), (101, 1, 5, True),
    (64, 2, 5, True), (65, 2, 5, True), (101, 2, 5, True),
    # the LA sites: k1, no bias (zeros on the JAX side)
    (64, 1, 1, False), (65, 1, 1, False), (101, 1, 1, False)])
def test_matches_jax_pallas_kernel(T, stride, K, bias):
    pytest.importorskip("jax")
    from tdanet_tpu.kernels.fused_pyramid import dw_conv_glob_ln as jax_fn
    arrs = _inputs(2, T, 64, K, bias, seed=T + 10 * K + stride)
    want = np.asarray(jax_fn(*arrs, stride=stride, K=K))
    got = dw_conv_glob_ln(*_torch(arrs, bias), stride=stride, K=K).numpy()
    assert got.shape == want.shape == (2, (T - 1) // stride + 1, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [512, 513, 700])
def test_chunked_matches_jax_chunked_kernel(T):
    pytest.importorskip("jax")
    from tdanet_tpu.kernels.fused_pyramid_chunked import (
        dw_conv_glob_ln_chunked as jax_fn)
    arrs = _inputs(2, T, 64, 5, True, seed=T)
    want = np.asarray(jax_fn(*arrs))
    got = dw_conv_glob_ln_chunked(*_torch(arrs, True)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_channels_first_view_matches_channels_last():
    """The model hands the kernel its (B, C, T) tensors as a transposed
    view; the result has that layout and the same values."""
    x, w, b, g, be = _torch(_inputs(2, 65, 16, 5, True), True)
    want = dw_conv_glob_ln(x, w, b, g, be, stride=2)
    view = x.transpose(1, 2).contiguous().transpose(1, 2)
    got = dw_conv_glob_ln(view, w, b, g, be, stride=2)
    assert got.stride(1) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_call_does_not_count_a_launch():
    before = dw_conv_glob_ln.launches
    dw_conv_glob_ln(*_torch(_inputs(1, 33, 8, 5, True), True))
    dw_conv_glob_ln_chunked(*_torch(_inputs(1, 33, 8, 5, True), True))
    assert dw_conv_glob_ln.launches == before


@pytest.mark.parametrize("bad", ["strided", "weight", "K", "stride"])
def test_rejects_what_the_kernel_does_not_take(bad):
    x, w, b, g, be = _torch(_inputs(1, 40, 8, 5, True), True)
    kw = {}
    if bad == "strided":  # neither T nor C innermost: raise, never copy
        x = torch.randn(1, 40, 16)[:, :, ::2]
    elif bad == "weight":
        w = w[:4]
    elif bad == "K":
        kw["K"] = 3
    else:
        kw["stride"] = 3
    with pytest.raises(ValueError):
        dw_conv_glob_ln(x, w, b, g, be, **kw)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    for T, stride, K, bias, t_major in [(2010, 1, 5, True, True),
                                        (1005, 2, 5, True, True),
                                        (126, 1, 1, False, True),
                                        (513, 1, 5, True, False),
                                        (101, 2, 5, False, False)]:
        arrs = _torch(_inputs(2, T, 512, K, bias, seed=T), bias)
        x, w, b, g, be = (None if a is None else a.cuda() for a in arrs)
        if t_major:
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        before = dw_conv_glob_ln.launches
        with torch.inference_mode():
            got = dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
            want = dw_conv_glob_ln_reference(x, w, b, g, be, stride=stride,
                                             K=K)
            got16 = dw_conv_glob_ln(x.bfloat16(), w, b, g, be,
                                    stride=stride, K=K)
        torch.cuda.synchronize()
        assert dw_conv_glob_ln.launches == before + 2
        assert got.stride(1 if t_major else 2) == 1  # x's layout kept
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (T, stride, K, err)
        ref16 = dw_conv_glob_ln_reference(x.bfloat16().float(), w, b, g, be,
                                          stride=stride, K=K)
        snr = 10 * torch.log10(ref16.square().sum()
                               / (got16.float() - ref16).square().sum())
        assert snr.item() >= 40, (T, stride, K, snr.item())
    with pytest.raises(ValueError, match="must lie on"):  # never a copy
        dw_conv_glob_ln(x, w.cpu(), b, g, be, stride=stride, K=K)


def cta_tiles(p, j):
    """The tiles CTA j owns, in the order it walks them (the kernel's
    lo = j N / G, hi = (j + 1) N / G)."""
    return range(j * p.n_tiles // p.grid, (j + 1) * p.n_tiles // p.grid)


def tile_owner(p, i):
    """The CTA that owns tile i (the kernel's owner())."""
    return ((i + 1) * p.grid - 1) // p.n_tiles


def tile_box(p, i):
    """Tile i as (sample, first output row, first channel), the kernel's
    numbering: sample by sample, channel tile by channel tile, time tile
    fastest."""
    b, r = divmod(i, p.per_sample)
    ct, tt = divmod(r, p.tiles_t)
    return b, tt * dw.TILE_T, ct * dw.TILE_C


# the served forward's 20 site shapes at C=512: (T_out, C)
SITE_SHAPES = [((T - 1) // stride + 1, 512) for T in SCALES
               for _, stride, _ in VARIANTS]


@pytest.mark.parametrize("B", [1, 4, 24])
@pytest.mark.parametrize("capacity", [7, 132 * 4, 132 * 8])
def test_plan_owns_every_output_once(B, capacity):
    """At every site shape: the wrapper's grid is at most the capacity
    (occupancy x SMs) and the tiles; the CTAs' runs cover the tiles in
    order, each once; every output element lies in exactly one tile;
    tile_owner inverts the runs."""
    for T_out, C in SITE_SHAPES:
        p = dw.plan(B, T_out, C, capacity)
        assert 1 <= p.grid <= min(capacity, p.n_tiles)
        runs = [cta_tiles(p, j) for j in range(p.grid)]
        assert all(len(r) >= 1 for r in runs)
        assert [i for r in runs for i in r] == list(range(p.n_tiles))
        owned = np.zeros((B, T_out, C), np.int32)
        for j, r in enumerate(runs):
            for i in (r[0], r[-1]):
                assert tile_owner(p, i) == j
            for i in r:
                b, t0, c0 = tile_box(p, i)
                owned[b, t0:t0 + dw.TILE_T, c0:c0 + dw.TILE_C] += 1
        assert (owned == 1).all(), (T_out, C)


def test_plan_needs_capacity():
    with pytest.raises(ValueError):
        dw.plan(1, 10, 8, 0)


def test_block_sites_are_the_model_calls(monkeypatch):
    """The site list the timing probe sums over is what a block runs."""
    from tdanet_tpu_torch.models import TDANetBest
    from tdanet_tpu_torch.models import components
    seen = []

    def spy(x, w, b, g, be, *, stride, K):
        seen.append((x.shape[1], K, stride, b is not None))
        return dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
    monkeypatch.setattr(components, "dw_conv_glob_ln", spy)
    model = TDANetBest(out_channels=8, in_channels=16, num_blocks=2,
                       upsampling_depth=5, enc_kernel_size=4)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(torch.randn(1, 32000))
    assert seen == block_sites(2010, 5) * 2
    assert len(seen) == 64


THREADS = 512  # a CTA of the kernel


def _chan(a, b):
    """The kernel's merge of Stats b (count, hi, lo, M2; mean hi + lo)
    into a, in fp32, elementwise over tensors: a keeps its hi."""
    (na, ha, la, qa), (nb, hb, lb, qb) = a, b
    n = na + nb
    r = 1.0 / torch.where(n > 0, n, torch.ones_like(n))
    d = (hb - ha) + (lb - la)
    both = (n, ha, la + d * (nb * r), qa + (qb + d * d * (na * r) * nb))
    return tuple(torch.where((na > 0) & (nb > 0), m,
                             torch.where(na > 0, x, y))
                 for m, x, y in zip(both, a, b))


def _tree(parts, o):
    """A shuffle-down tree over the last axis from offset o: lane 0's
    result."""
    while o:
        parts = _chan(tuple(p[..., :o] for p in parts),
                      tuple(p[..., o:2 * o] for p in parts))
        o //= 2
    return tuple(p[..., 0] for p in parts)


def _block_merge(parts):
    """The kernel's block_merge of one Stats per thread: a tree in each
    warp, then one over the 16 warp results in warp 0."""
    warps = _tree(tuple(p.reshape(THREADS // 32, 32) for p in parts), 16)
    return _tree(warps, THREADS // 64)


def _mirror_stats(y, p):
    """Each sample's (count, hi, lo, M2) of y (B, T_out, C) fp32 as the
    kernel merges them: per tile one sum and one sum of squares of y - y0,
    y0 the tile's first value; folded per (sample, CTA) in tile order; per
    sample the CTAs' parts, one a thread in CTA order, a block merge."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    zero = (f32(0.0),) * 4
    partials = {}
    for j in range(p.grid):
        for i in cta_tiles(p, j):
            b, t0, c0 = tile_box(p, i)
            v = y[b, t0:t0 + dw.TILE_T, c0:c0 + dw.TILE_C]
            y0 = v[0, 0]
            s1, s2 = (v - y0).sum(), (v - y0).square().sum()
            n = f32(float(v.numel()))
            lo = s1 / n
            partials[b, j] = _chan(partials.get((b, j), zero),
                                   (n, y0, lo, s2 - s1 * lo))
    stats = []
    for b in range(y.shape[0]):
        first = b * p.per_sample
        js = list(range(tile_owner(p, first),
                        tile_owner(p, first + p.per_sample - 1) + 1))
        assert len(js) <= THREADS  # one part a thread
        lanes = tuple(torch.zeros(THREADS) for _ in range(4))
        for k, j in enumerate(js):
            for lane, part in zip(lanes, partials[b, j]):
                lane[k] = part
        stats.append(_block_merge(lanes))
    return stats


@pytest.mark.parametrize("B,T_out,C,capacity,offset", [
    (1, 2010, 512, 528, 0.0), (1, 2010, 512, 528, 1e3),
    (1, 2010, 512, 100, 1e3), (2, 300, 96, 7, 1e3), (3, 126, 512, 40, 0.0)])
def test_merge_mirror_matches_fp64_two_pass(B, T_out, C, capacity, offset):
    """The kernel's merge order and forms, mirrored in fp32, give every
    sample's mean and variance within 1e-6 relative of fp64 two-pass
    statistics, also on activations with a large common offset, where
    fp32 E[y^2] - E[y]^2 fails."""
    rng = np.random.default_rng(T_out + C)
    y64 = offset + rng.standard_normal((B, T_out, C)) \
        * rng.uniform(0.5, 2.0, (B, 1, 1))
    y = torch.from_numpy(y64.astype(np.float32))
    p = dw.plan(B, T_out, C, capacity)
    for b, (n, hi, lo, m2) in enumerate(_mirror_stats(y, p)):
        assert n.dtype == hi.dtype == lo.dtype == m2.dtype == torch.float32
        ref = y[b].double()
        want_var = (ref - ref.mean()).square().mean().item()
        assert n.item() == T_out * C
        mean = hi.item() + lo.item()
        assert abs(mean - ref.mean().item()) <= 1e-6 * abs(
            ref.mean().item()) + 1e-6
        assert abs(m2.item() / n.item() - want_var) <= 1e-6 * want_var
        if offset:  # the one-pass form in fp32 is far off here
            yb = y[b]
            naive = (yb.square().mean() - yb.mean().square()).item()
            assert abs(naive - want_var) > 1e-3 * want_var


@pytest.mark.gpu
def test_cuda_kernel_at_every_site_shape():
    """The kernel against its plain version at the 20 site shapes, B 1
    and 4, fp32 and bf16 (bf16 parameters, as a bf16 model has them), in
    the model's (B, C, T) layout and in (B, T, C); a second run equal bit
    for bit; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    for B in (1, 4):
        for T in SCALES:
            for K, stride, bias in VARIANTS:
                arrs = _torch(_inputs(B, T, 512, K, bias, seed=T + K), bias)
                arrs = [None if a is None else a.cuda() for a in arrs]
                for t_major in (True, False):
                    x = arrs[0]
                    if t_major:
                        x = x.transpose(1, 2).contiguous().transpose(1, 2)
                    for dtype in (torch.float32, torch.bfloat16):
                        xd = x.to(dtype)
                        ps = [None if a is None else a.to(dtype)
                              for a in arrs[1:]]
                        before = dw_conv_glob_ln.launches
                        with torch.inference_mode():
                            got = dw_conv_glob_ln(xd, *ps, stride=stride,
                                                  K=K)
                            again = dw_conv_glob_ln(xd, *ps, stride=stride,
                                                    K=K)
                            ref = dw_conv_glob_ln_reference(
                                xd.float(), *[None if a is None else a.float()
                                              for a in ps],
                                stride=stride, K=K)
                        torch.cuda.synchronize()
                        assert dw_conv_glob_ln.launches == before + 2
                        assert torch.equal(got, again)
                        assert got.dtype == dtype
                        assert got.stride(1 if t_major else 2) == 1
                        case = (B, T, K, stride, t_major, dtype)
                        if dtype == torch.float32:
                            err = (got - ref).abs().max().item()
                            assert err <= 1e-4 * ref.abs().max().item(), case
                        else:
                            snr = 10 * torch.log10(
                                ref.square().sum()
                                / (got.float() - ref).square().sum())
                            assert snr.item() >= 40, case


@pytest.mark.gpu
def test_cuda_graph_replay_equals_eager():
    """The cooperative launch is captured in a CUDA graph, and its replay
    gives the eager output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for T, stride, K, bias in [(2010, 1, 5, True), (2010, 2, 5, True),
                               (126, 1, 1, False)]:
        arrs = _torch(_inputs(2, T, 512, K, bias, seed=T), bias)
        x, w, b, g, be = (None if a is None else a.cuda() for a in arrs)
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        with torch.inference_mode():
            eager = dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (T, stride, K)


# -- the backward --------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread a test, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BACKWARD_CASES = [  # (T, stride, K, bias): odd and even T, both strides
    (37, 1, 5, True), (37, 2, 5, True), (40, 2, 5, False),
    (40, 1, 1, False), (37, 2, 1, True), (41, 1, 5, False)]


def _backward_operands(B, T, C, K, bias, seed, t_major):
    """fp64 operands in the given layout, and a cotangent dy in the
    output's layout."""
    x, w, b, g, be = (torch.from_numpy(a).double() for a in
                      _inputs(B, T, C, K, bias, seed))
    if t_major:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    return x, w, (b if bias else None), g, be


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("t_major", [True, False])
@pytest.mark.parametrize("T,stride,K,bias", BACKWARD_CASES)
def test_backward_formula_matches_autograd_and_jax(T, stride, K, bias,
                                                   t_major):
    """dw_conv_glob_ln_backward_reference against torch autograd through
    dw_conv_glob_ln_reference and against jax.vjp of the JAX package's own
    ConvNorm arithmetic (ops.conv1d + ops.glob_ln, what its trainer
    differentiates), in fp64 at 1e-10 of each gradient's largest
    magnitude."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from tdanet_tpu import ops as jops
    B, C = 2, 24
    x, w, b, g, be = _backward_operands(B, T, C, K, bias, T + K, t_major)
    T_out = (T - 1) // stride + 1
    dy = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (B, T_out, C)))
    got = dw.dw_conv_glob_ln_backward_reference(dy, x, w, b, g,
                                                stride=stride, K=K)
    assert got[0].stride() == x.stride() or not t_major
    ps = [p.clone().requires_grad_() for p in (x, w, b, g, be)
          if p is not None]
    out = dw_conv_glob_ln_reference(ps[0], ps[1], ps[2] if bias else None,
                                    *ps[-2:], stride=stride, K=K)
    want = torch.autograd.grad(out, ps, dy)
    got = [v for v in got if v is not None]
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                   atol=1e-10 * r.abs().max().item())

    def convnorm(xc, w_, b_, g_, be_):
        y = jops.conv1d(xc, {"weight": w_, "bias": b_}, stride=stride,
                        padding=(K - 1) // 2, groups=C)
        return jops.glob_ln(y, {"gamma": g_, "beta": be_})

    with jax.enable_x64():
        args = [jnp.asarray(a.numpy()) for a in (
            x.transpose(1, 2), w, b if bias else torch.zeros(C), g, be)]
        _, vjp = jax.vjp(convnorm, *args)
        jgrads = vjp(jnp.asarray(dy.transpose(1, 2).numpy()))
    jgrads = [np.asarray(jgrads[0]).transpose(0, 2, 1), *map(
        np.asarray, jgrads[1:])]
    if not bias:
        jgrads.pop(2)
    for a, r in zip(got, jgrads):
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max())


def _plain_launches(monkeypatch, calls):
    """The Function's two launches as their plain versions, with the
    kernels' layouts and dtypes (x's layout for out and dx, fp32 (B, 3)
    statistics, each parameter's gradient in its dtype); each call is
    recorded."""
    def launch(x, weight, bias, gamma, beta, stride, K, eps,
               want_stats=False):
        calls.append("forward")
        out = dw._like(x, dw._out_len(x.shape[1], K, stride))
        out.copy_(dw_conv_glob_ln_reference(x, weight, bias, gamma, beta,
                                            stride=stride, K=K, eps=eps))
        stats = dw.stats_reference(x, weight, bias, stride=stride, K=K,
                                   eps=eps) if want_stats else None
        return out, stats

    def launch_backward(dy, x, weight, bias, gamma, stats, stride, K):
        calls.append("backward")
        inner = 1 if x.stride(1) == 1 else 2
        assert dy.stride(inner) == 1 and dy.is_contiguous() == (inner == 2)
        grads = dw.dw_conv_glob_ln_backward_reference(
            dy, x, weight, bias, gamma, stride=stride, K=K, stats=stats)
        dx = dw._like(x, x.shape[1])
        dx.copy_(grads[0])
        return (dx, *grads[1:])

    monkeypatch.setattr(dw, "_launch", launch)
    monkeypatch.setattr(dw, "_launch_backward", launch_backward)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("t_major", [True, False])
def test_autograd_function_wiring_on_cpu(monkeypatch, t_major):
    """DwConvGlobLnFunction with its launches patched to the plain
    versions: the gradients of autograd through the plain forward, dx in
    x's layout and dtype, fp32 parameter gradients for fp32 parameters
    under fp64 activations, a dy that arrives as an expanded view made
    contiguous in the output's layout, and the same gradients under
    torch.utils.checkpoint (forward launched again, backward once)."""
    calls = []
    _plain_launches(monkeypatch, calls)
    x, w, b, g, be = _backward_operands(2, 37, 8, 5, True, 3, t_major)
    w32, b32, g32, be32 = (p.float().requires_grad_() for p in (w, b, g,
                                                                 be))
    x.requires_grad_()

    def run(fn):
        out = fn(x, w32, b32, g32, be32)
        # an expanded dy (stride 0): the Function must make it contiguous
        return torch.autograd.grad(out.sum(), (x, w32, b32, g32, be32))

    fn = (lambda *a: dw.DwConvGlobLnFunction.apply(*a, 2, 5, 1e-8))
    got = run(fn)
    assert calls == ["forward", "backward"]
    assert got[0].dtype == torch.float64 and got[0].stride() == x.stride()
    assert all(v.dtype == torch.float32 for v in got[1:])
    want = run(lambda *a: dw_conv_glob_ln_reference(*a, stride=2, K=5))
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)
    calls.clear()
    again = run(lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False))
    assert calls == ["forward", "forward", "backward"]
    for a, r in zip(again, got):
        assert torch.equal(a, r)


def test_backward_wrapper_on_cpu_takes_the_plain_version():
    x, w, b, g, be = _backward_operands(1, 33, 8, 5, True, 1, True)
    _, stats = dw.forward_with_stats(x, w, b, g, be, stride=2)
    dy = torch.randn(1, 17, 8, dtype=torch.float64)
    before = dw.dw_conv_glob_ln_backward.launches
    got = dw.dw_conv_glob_ln_backward(dy, x, w, b, g, stats, stride=2)
    want = dw.dw_conv_glob_ln_backward_reference(dy, x, w, b, g, stride=2)
    assert dw.dw_conv_glob_ln_backward.launches == before
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        dw.dw_conv_glob_ln_backward(dy[:, :5], x, w, b, g, stats, stride=2)


@pytest.mark.gpu
def test_cuda_backward_matches_plain():
    """The backward kernel against the plain backward (fp32 and bf16
    activations over fp32 parameters, both layouts, odd T, K 1/3/5/7 at
    both strides, 8 and 16 rows a thread), a rerun equal bit for bit; and
    the gradients through dw_conv_glob_ln on the card (one forward and one
    backward launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    for T, stride, K, bias in [(3010, 1, 5, True), (1505, 2, 5, True),
                               (189, 1, 1, False), (753, 1, 5, False),
                               (1505, 1, 3, False), (189, 1, 3, True),
                               (377, 2, 3, True), (1505, 1, 7, True),
                               (189, 1, 7, False), (753, 2, 7, True)]:
        for t_major in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                x, w, b, g, be = (None if p is None else p.float().cuda()
                                  for p in _backward_operands(
                                      2, T, 512, K, bias, T, t_major))
                x = x.to(dtype)
                x.requires_grad_()
                for p in (w, b, g, be):
                    if p is not None:
                        p.requires_grad_()
                f0, b0 = (dw_conv_glob_ln.launches,
                          dw.dw_conv_glob_ln_backward.launches)
                out = dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K)
                dy = torch.randn(out.shape, device="cuda").to(dtype)
                ps = [p for p in (x, w, b, g, be) if p is not None]
                got = torch.autograd.grad(out, ps, dy)
                torch.cuda.synchronize()
                assert (dw_conv_glob_ln.launches - f0,
                        dw.dw_conv_glob_ln_backward.launches - b0) == (1, 1)
                assert got[0].dtype == dtype
                assert got[0].stride() == x.stride()
                ref = dw.dw_conv_glob_ln_backward_reference(
                    dy.float(), x.detach().float(), w, b, g, stride=stride,
                    K=K)
                ref = [r for r in ref if r is not None]
                for a, r in zip(got, ref):
                    if dtype == torch.float32:
                        err = (a - r).abs().max().item()
                        assert err <= 1e-4 * r.abs().max().item()
                    else:
                        snr = 10 * torch.log10(r.square().sum() / (
                            a.float() - r).square().sum())
                        assert snr.item() >= 40
                again = torch.autograd.grad(
                    dw_conv_glob_ln(x, w, b, g, be, stride=stride, K=K),
                    ps, dy)
                assert all(torch.equal(a, c) for a, c in zip(got, again))
