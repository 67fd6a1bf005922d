"""The port's window partition / merge pair against the JAX package's:
the Pallas kernels (interpret mode off TPU, as tests/test_window_kernel.py
runs them) and their XLA twins, bit for bit, forward and gradients. The
CUDA kernels are held against their plain versions on a card only:
    python -m pytest --noconftest tests/test_torch_window_kernel.py -m gpu

JAX is imported inside the tests that need it, so the card's test also
runs where JAX is absent.
"""
import numpy as np
import pytest
import torch

from tdanet_tpu_torch import kernels as tk
from tdanet_tpu_torch.kernels import (
    roll_and_window_partition, roll_and_window_partition_reference,
    window_merge_and_roll, window_merge_and_roll_reference,
    window_partition, window_reverse)

# the JAX suite's shape, and one with the Swin path's C and window
SHAPES = [((2, 16, 16, 32), 4), ((2, 14, 21, 96), 7)]
SHIFTS = [0, 2]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,ws", SHAPES)
def test_partition_matches_jax_pallas_and_xla(shape, ws, shift):
    pytest.importorskip("jax")
    from tdanet_tpu import kernels as jk
    x = _x(shape, 0)
    got = roll_and_window_partition(torch.from_numpy(x), shift, ws).numpy()
    B, H, W, C = shape
    assert got.shape == (B * (H // ws) * (W // ws), ws, ws, C)
    np.testing.assert_allclose(
        got, np.asarray(jk.roll_and_window_partition(x, shift, ws)), atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jk.roll_and_window_partition_xla(x, shift, ws)),
        atol=0)
    plain = roll_and_window_partition_reference(torch.from_numpy(x), shift,
                                                ws)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,ws", SHAPES)
def test_merge_matches_jax_pallas_and_xla(shape, ws, shift):
    pytest.importorskip("jax")
    from tdanet_tpu import kernels as jk
    B, H, W, C = shape
    wins = _x((B * (H // ws) * (W // ws), ws, ws, C), 1)
    got = window_merge_and_roll(torch.from_numpy(wins), shift, ws, H,
                                W).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(
        got, np.asarray(jk.window_merge_and_roll(wins, shift, ws, H, W)),
        atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jk.window_merge_and_roll_xla(wins, shift, ws, H, W)),
        atol=0)
    plain = window_merge_and_roll_reference(torch.from_numpy(wins), shift,
                                            ws, H, W)
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("shape,ws", SHAPES)
def test_roundtrip(shape, ws, shift):
    x = torch.from_numpy(_x(shape, 2))
    wins = roll_and_window_partition(x, shift, ws)
    back = window_merge_and_roll(wins, shift, ws, shape[1], shape[2])
    assert torch.equal(back, x)
    assert torch.equal(window_reverse(window_partition(x, ws), ws, shape[1],
                                      shape[2]), x)


@pytest.mark.parametrize("shape,ws", SHAPES)
def test_gradients_match_jax_grad_through_the_pallas_pair(shape, ws):
    """Each Function's backward is the other op with the same shift; the
    gradients equal jax.grad through the Pallas pair's custom VJPs."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from tdanet_tpu import kernels as jk
    B, H, W, C = shape
    x = _x(shape, 3)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jk.roll_and_window_partition(v, 2, ws) ** 2))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(
        roll_and_window_partition(xt, 2, ws).square().sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, atol=0)
    ref, = torch.autograd.grad(
        roll_and_window_partition_reference(xt, 2, ws).square().sum(), xt)
    assert torch.equal(got, ref)

    wins = np.asarray(jk.roll_and_window_partition(x, 2, ws))
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jk.window_merge_and_roll(v, 2, ws, H, W) ** 3))(jnp.asarray(wins)))
    wt = torch.tensor(wins).requires_grad_()
    got, = torch.autograd.grad(
        window_merge_and_roll(wt, 2, ws, H, W).pow(3).sum(), wt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ref, = torch.autograd.grad(
        window_merge_and_roll_reference(wt, 2, ws, H, W).pow(3).sum(), wt)
    assert torch.equal(got, ref)


def test_gradient_of_a_noncontiguous_cotangent():
    """The incoming gradient may be a view (here a permuted weight)."""
    x = torch.from_numpy(_x((2, 8, 8, 6), 4)).requires_grad_()
    weight = torch.from_numpy(_x((4, 4, 8, 6), 5)).permute(2, 0, 1, 3)
    got, want = (torch.autograd.grad((fn(x, 1, 4) * weight).sum(), x)[0]
                 for fn in (roll_and_window_partition,
                            roll_and_window_partition_reference))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.int32])
def test_any_element_type(dtype):
    x = torch.from_numpy(_x((1, 8, 8, 5), 6) * 100).to(dtype)
    wins = roll_and_window_partition(x, 3, 4)
    assert wins.dtype == dtype
    assert torch.equal(window_merge_and_roll(wins, 3, 4, 8, 8), x)


def test_rejections():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="multiples of the window"):
        roll_and_window_partition(x, 0, 3)
    with pytest.raises(ValueError, match="shift"):
        roll_and_window_partition(x, 4, 4)
    with pytest.raises(ValueError, match="shift"):
        roll_and_window_partition(x, -1, 4)
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        roll_and_window_partition(x[0], 0, 4)
    wins = torch.zeros(4, 4, 4, 4)
    with pytest.raises(ValueError, match="multiples of the window"):
        window_merge_and_roll(wins, 0, 4, 8, 6)
    with pytest.raises(ValueError, match="shift"):
        window_merge_and_roll(wins, 4, 4, 8, 8)
    with pytest.raises(ValueError, match="windows must be"):
        window_merge_and_roll(wins[:, :2], 0, 4, 8, 8)
    with pytest.raises(ValueError, match="do not fill"):
        window_merge_and_roll(wins[:3], 0, 4, 8, 8)
    with pytest.raises(ValueError, match="32 bits"):
        roll_and_window_partition(
            torch.zeros(1).expand(2 ** 11, 2 ** 10, 2 ** 10, 1), 0, 4)


def test_exports_follow_the_jax_package():
    assert tk.WindowProcess is roll_and_window_partition
    assert tk.WindowProcessReverse is window_merge_and_roll
    assert set(tk.__all__) >= {
        "WindowProcess", "WindowProcessReverse", "roll_and_window_partition",
        "window_merge_and_roll"}


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    before = (roll_and_window_partition.launches,
              window_merge_and_roll.launches)
    n = 0
    for shape, ws, shift in [((2, 56, 56, 96), 7, 3), ((1, 7, 7, 768), 7, 0),
                             ((2, 8, 12, 37), 4, 1)]:
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            x = torch.randn(shape, generator=gen).to(dtype).cuda()
            x.requires_grad_()
            wins = roll_and_window_partition(x, shift, ws)
            ref = roll_and_window_partition_reference(x, shift, ws)
            assert torch.equal(wins, ref)
            back = window_merge_and_roll(wins, shift, ws, *shape[1:3])
            assert torch.equal(back, x)
            got, = torch.autograd.grad(back.pow(3).sum(), x)
            want, = torch.autograd.grad(
                window_merge_and_roll_reference(ref, shift, ws, *shape[1:3])
                .pow(3).sum(), x)
            assert torch.equal(got, want)
            n += 1
    torch.cuda.synchronize()
    # per case: one forward and one backward launch of each kernel
    assert (roll_and_window_partition.launches - before[0],
            window_merge_and_roll.launches - before[1]) == (2 * n, 2 * n)
