"""The port's ops against ``tdanet_tpu.ops`` in float64 (JAX under
``jax.enable_x64()``), at rtol 1e-12: the same math, not merely fp32-close.
"""
import numpy as np
import pytest
import torch

from tdanet_tpu_torch.models.components import MultiHeadAttentionModule
from tdanet_tpu_torch.ops import basic as tops

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from tdanet_tpu import ops as jops  # noqa: E402

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: parallel test workers would otherwise
    oversubscribe the cores (each op's parallel region waiting for threads
    the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax(fn, *args, **kw):
    with jax.enable_x64():
        conv = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args]
        return np.asarray(fn(*conv, **kw))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and got.dtype == np.float64
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("C_in,C_out,K,stride,groups,T,bias", [
    (16, 32, 1, 1, 1, 50, True),      # dense 1x1 (proj, bottleneck)
    (16, 16, 5, 1, 16, 51, True),     # depthwise k5
    (16, 16, 5, 2, 16, 51, True),     # stride-2 depthwise, odd T
    (16, 16, 5, 2, 16, 50, True),
    (16, 16, 1, 1, 16, 37, False),    # depthwise k1 (the LA sites)
    (1, 33, 64, 16, 1, 1043, False),  # the framing encoder
])
def test_conv1d(C_in, C_out, K, stride, groups, T, bias):
    r = _rng(K + T)
    x = r.standard_normal((2, C_in, T))
    w = r.standard_normal((C_out, C_in // groups, K))
    b = r.standard_normal(C_out) if bias else None
    pad = K // 2
    params = {"weight": w} if b is None else {"weight": w, "bias": b}
    want = _jax(lambda x_: jops.conv1d(x_, jax.tree_util.tree_map(
        jnp.asarray, params), stride=stride, padding=pad, groups=groups), x)
    got = tops.conv1d(_t(x), _t(w), None if b is None else _t(b),
                      stride=stride, padding=pad, groups=groups)
    _close(got, want)


def test_conv_transpose1d_overlap_add():
    r = _rng(1)
    x = r.standard_normal((2, 66, 70))
    w = r.standard_normal((66, 2, 64))
    want = _jax(lambda x_, w_: jops.conv_transpose1d(
        x_, {"weight": w_}, stride=16, padding=32), x, w)
    _close(tops.conv_transpose1d(_t(x), _t(w), stride=16, padding=32), want)


@pytest.mark.parametrize("n", [1, 8])
def test_prelu(n):
    r = _rng(n)
    x = r.standard_normal((2, 8, 30))
    a = r.standard_normal(n)
    want = _jax(lambda x_, a_: jops.prelu(x_, {"weight": a_}), x, a)
    _close(tops.prelu(_t(x), _t(a)), want)


def test_glob_ln():
    r = _rng(2)
    x = r.standard_normal((3, 8, 41)) * 3 + 1
    g, b = r.standard_normal(8), r.standard_normal(8)
    want = _jax(lambda x_, g_, b_: jops.glob_ln(x_, {"gamma": g_,
                                                     "beta": b_}), x, g, b)
    _close(tops.glob_ln(_t(x), _t(g), _t(b)), want)


def test_group_norm1():
    r = _rng(12)
    x = r.standard_normal((3, 8, 41)) * 3 + 1
    w, b = r.standard_normal(8), r.standard_normal(8)
    want = _jax(lambda x_, w_, b_: jops.group_norm1(
        x_, {"weight": w_, "bias": b_}), x, w, b)
    _close(tops.group_norm1(_t(x), _t(w), _t(b)), want)


def test_gelu_is_the_exact_erf_form():
    x = _rng(13).standard_normal((4, 33)) * 3
    want = _jax(lambda x_: jax.nn.gelu(x_, approximate=False), x)
    _close(tops.gelu(_t(x)), want)


@pytest.mark.parametrize("n_in,n_out,K,groups,bias", [
    (12, 20, 1, 1, False),    # MlpConv's fc1
    (16, 16, 5, 16, True)])   # depthwise: the fused kernel (plain on the CPU)
def test_conv_norm_gn_matches_jax(n_in, n_out, K, groups, bias):
    from tdanet_tpu.models.components import ConvNorm as J
    from tdanet_tpu_torch.models.components import ConvNorm
    r = _rng(14 + K)
    p = {"conv": {"weight": r.standard_normal((n_out, n_in // groups, K))},
         "norm": {"weight": r.standard_normal(n_out),
                  "bias": r.standard_normal(n_out)}}
    if bias:
        p["conv"]["bias"] = r.standard_normal(n_out)
    x = r.standard_normal((2, n_in, 23))
    want = _jax(lambda x_: J(n_in, n_out, K, groups=groups, bias=bias,
                             norm="gn").apply(
        jax.tree_util.tree_map(jnp.asarray, p), x_), x)
    m = ConvNorm(n_in, n_out, K, groups=groups, bias=bias,
                 norm="gn").double()
    assert m.on_kernel == (groups == n_in == n_out)
    assert set(m.state_dict()) == {f"{a}.{b}" for a in p for b in p[a]}
    m.load_state_dict({f"{a}.{b}": _t(v) for a in p
                       for b, v in p[a].items()})
    with torch.no_grad():
        _close(m(_t(x)), want)
    with pytest.raises(ValueError):
        ConvNorm(4, 4, 1, norm="bn")


def test_layer_norm():
    r = _rng(3)
    x = r.standard_normal((2, 9, 16)) * 2 + 0.5
    w, b = r.standard_normal(16), r.standard_normal(16)
    want = _jax(lambda x_, w_, b_: jops.layer_norm(x_, {"weight": w_,
                                                        "bias": b_}), x, w, b)
    _close(tops.layer_norm(_t(x), _t(w), _t(b)), want)


@pytest.mark.parametrize("L,out", [(2010, 126), (1005, 126), (65, 9),
                                   (13, 5), (9, 9)])
def test_adaptive_avg_pool1d(L, out):
    x = _rng(L).standard_normal((2, 4, L))
    want = _jax(lambda x_: jops.adaptive_avg_pool1d(x_, out), x)
    _close(tops.adaptive_avg_pool1d(_t(x), out), want)


@pytest.mark.parametrize("L,out", [(14, 110), (1005, 2010), (503, 1005),
                                   (7, 100), (300, 1001), (126, 252)])
def test_interpolate_nearest(L, out):
    """Includes L=14 -> 110, where torch's float32 index floor maps output
    55 to source 7 (exact arithmetic gives 6)."""
    x = _rng(L).standard_normal((2, 3, L))
    want = _jax(lambda x_: jops.interpolate_nearest(x_, out), x)
    got = tops.interpolate_nearest(_t(x), out)
    np.testing.assert_array_equal(got.numpy(), want)
    if (L, out) == (14, 110):
        np.testing.assert_array_equal(got.numpy()[..., 55], x[..., 7])


@pytest.mark.parametrize("T", [8000, 8001, 12345, 64, 1])
def test_pad_signal(T):
    x = _rng(T).standard_normal((2, T))
    with jax.enable_x64():
        want, want_rest = jops.pad_signal(jnp.asarray(x), 64, 16)
    got, rest = tops.pad_signal(_t(x), 64, 16)
    assert rest == want_rest
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,C", [(126, 512), (1, 8), (37, 64)])
def test_sinusoidal_pe_bit_equal(L, C):
    want = np.asarray(jops.sinusoidal_pe(L, C))
    got = tops.sinusoidal_pe(L, C)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _mha_params(E, seed):
    r = _rng(seed)
    return (r.standard_normal((3 * E, E)) / np.sqrt(E),
            r.standard_normal(3 * E) * 0.1,
            r.standard_normal((E, E)) / np.sqrt(E),
            r.standard_normal(E) * 0.1)


def test_multi_head_attention():
    E, heads = 32, 8
    wi, bi, wo, bo = _mha_params(E, 4)
    q = _rng(5).standard_normal((3, 10, E))
    params = {"in_proj_weight": wi, "in_proj_bias": bi,
              "out_proj": {"weight": wo, "bias": bo}}
    want = _jax(lambda q_: jops.multi_head_attention(
        q_, q_, q_, jax.tree_util.tree_map(jnp.asarray, params), heads), q)
    got = tops.multi_head_attention(_t(q), _t(q), _t(q), _t(wi), _t(bi),
                                    _t(wo), _t(bo), heads)
    _close(got, want)


@pytest.mark.parametrize("B,per_utterance", [(1, False), (3, True)])
def test_mha_collapse_equals_full_batch_axis_path(B, per_utterance):
    """Attention over a batch axis of length one is softmax over one
    element: the module's collapse to out_proj(v_proj(x)) equals the full
    path, row by row."""
    E, T = 32, 11
    m = MultiHeadAttentionModule(E).double()
    wi, bi, wo, bo = _mha_params(E, 6)
    with torch.no_grad():
        m.attn.in_proj_weight.copy_(_t(wi))
        m.attn.in_proj_bias.copy_(_t(bi))
        m.attn.out_proj.weight.copy_(_t(wo))
        m.attn.out_proj.bias.copy_(_t(bo))
    x = _t(_rng(7).standard_normal((B, E, T)))
    with torch.no_grad():
        got = m(x, per_utterance=per_utterance)
        for i in range(B):
            xt = tops.layer_norm(x[i:i + 1].transpose(1, 2),
                                 m.attn_in_norm.weight, m.attn_in_norm.bias)
            xt = xt + tops.sinusoidal_pe(T, E, xt.dtype)
            full = tops.multi_head_attention(xt, xt, xt, _t(wi), _t(bi),
                                             _t(wo), _t(bo), 8)
            want = tops.layer_norm(full + full, m.norm.weight, m.norm.bias)
            _close(got[i:i + 1], want.transpose(1, 2).numpy())


@pytest.mark.parametrize("B", [1, 2])
def test_mha_module_matches_jax(B):
    from tdanet_tpu.models.components import MultiHeadAttentionModule as J
    E, T = 32, 9
    wi, bi, wo, bo = _mha_params(E, 8)
    r = _rng(9)
    n1w, n1b, n2w, n2b = (r.standard_normal(E) for _ in range(4))
    p = {"attn_in_norm": {"weight": n1w, "bias": n1b},
         "attn": {"in_proj_weight": wi, "in_proj_bias": bi,
                  "out_proj": {"weight": wo, "bias": bo}},
         "norm": {"weight": n2w, "bias": n2b}}
    x = r.standard_normal((B, E, T))
    want = _jax(lambda x_: J(E).apply(
        jax.tree_util.tree_map(jnp.asarray, p), x_), x)
    m = MultiHeadAttentionModule(E).double()
    with torch.no_grad():
        for k, v in {"attn_in_norm.weight": n1w, "attn_in_norm.bias": n1b,
                     "attn.in_proj_weight": wi, "attn.in_proj_bias": bi,
                     "attn.out_proj.weight": wo, "attn.out_proj.bias": bo,
                     "norm.weight": n2w, "norm.bias": n2b}.items():
            m.get_parameter(k).copy_(_t(v))
        got = m(_t(x))
    _close(got, want)
