"""The fused depthwise conv + GlobLN of the port against the JAX package's
Pallas kernels (interpret mode off TPU, as tests/test_fused_pyramid.py
runs them), and the CUDA kernel against its plain version on a card.

JAX is imported inside the tests that need it, so the CUDA test also runs
where JAX is absent:
    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
"""
import numpy as np
import pytest
import torch

from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
    dw_conv_glob_ln, dw_conv_glob_ln_chunked, dw_conv_glob_ln_reference)

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
