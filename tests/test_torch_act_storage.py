"""8-bit activation storage (``ops.act_storage``, ``ops.store_activation``)
against the JAX package's: the store itself bit for bit in every mode and
dtype, fp8_e4m3's NaN past its range included; the thread-local mode;
the hooks at the landmarks of a small TDANetBest (width 32/64, 3 blocks,
pyramid depth 3, 8 kHz, the same perturbed weights on both sides) in
float64, off and under each mode; the staged (progressive) forward under
a mode."""
import threading

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu import ops as jops  # noqa: E402
from tdanet_tpu_torch import ops as tops  # noqa: E402
from tdanet_tpu_torch.ops import basic as tbasic  # noqa: E402

MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CFG = dict(out_channels=32, in_channels=64, num_blocks=3,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
B, T = 2, 4000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    """Normal values at three scales, and values at and past both fp8
    ranges (e4m3fn: 448, NaN above 464; e5m2: 57344, inf above 61440),
    signed zeros, a subnormal, both infinities and a NaN."""
    rng = np.random.default_rng(seed)
    edge = [448.0, 463.9, 464.0, 464.00003, 465.0, 479.0, 480.0, 500.0,
            1e4, -7e4, 57344.0, 61439.0, 61440.0, 61441.0, 65520.0, 1e6,
            2.0 ** -10, 1e-9, 0.0, -0.0, np.inf, -np.inf, np.nan, -464.5]
    x = np.concatenate([rng.standard_normal(3000),
                        30 * rng.standard_normal(500),
                        3000 * rng.standard_normal(500), edge])
    return np.resize(x, (2, 4, 1008))


def _finite_inputs(seed=0):
    x = _inputs(seed)
    return np.where(np.isfinite(x), x, 1.5)


def _same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(np.all((a == b)
                                              | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_store_equals_jax_bit_for_bit(mode, dtype):
    """Eager JAX ``store_activation`` and the port's on the same values:
    equal bit for bit (int8 on finite inputs: its absmax scale of an inf
    is NaN everywhere on both sides)."""
    jd, td = DTYPES[dtype]
    x = _inputs() if mode != "int8" else _finite_inputs()
    with jax.enable_x64():
        xj = jnp.asarray(x).astype(jd)
        with jops.act_storage(mode):
            want = np.asarray(jops.store_activation(xj).astype(jnp.float64))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float64))).to(td)
    with tops.act_storage(mode):
        got = tops.store_activation(xt)
    assert got.dtype == td
    assert _same(got.double().numpy(), want)


def test_fp8_e4m3_nan_threshold():
    """Past 464 (the midpoint of 448 and 480) float8_e4m3fn has no value:
    the JAX cast gives NaN, torch's saturates at 448; the port gives NaN.
    464 itself rounds to 448 (to even); e5m2 keeps its infinities."""
    f32 = np.float32
    x = torch.tensor([463.9, 464.0, np.nextafter(f32(464), f32(1e9)), 465.0,
                      500.0, 1e4, -7e4, -464.0, float("inf"), 1.0],
                     dtype=torch.float32)
    assert x.to(torch.float8_e4m3fn).float()[5].item() == 448.0
    with tops.act_storage("fp8_e4m3"):
        y = tops.store_activation(x)
    assert y[:2].tolist() == [448.0, 448.0]
    assert torch.isnan(y[2:7]).all() and torch.isnan(y[8])
    assert y[7].item() == -448.0 and y[9].item() == 1.0
    with tops.act_storage("fp8_e5m2"):
        z = tops.store_activation(torch.tensor([float("inf"), 6e4, 7e4]))
    assert z.tolist() == [float("inf"), 57344.0, float("inf")]


def test_off_is_the_identity_and_modes_nest():
    x = torch.randn(3, 5)
    assert tops.act_storage_mode() is None
    assert tops.store_activation(x) is x
    with tops.act_storage("int8"):
        with tops.act_storage(None):
            assert tops.store_activation(x) is x
        assert tops.act_storage_mode() == "int8"
        assert tops.store_activation(x) is not x
    assert tops.act_storage_mode() is None
    with pytest.raises(ValueError, match="unsupported"):
        tops.act_storage("fp16")


def test_mode_is_thread_local():
    """A mode set in one thread is not seen in another, either way."""
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def worker():
        seen["worker_before"] = tops.act_storage_mode()
        with tops.act_storage("fp8_e5m2"):
            entered.set()
            release.wait(10)
            seen["worker_inside"] = tops.act_storage_mode()
        seen["worker_after"] = tops.act_storage_mode()

    with tops.act_storage("int8"):
        t = threading.Thread(target=worker)
        t.start()
        entered.wait(10)
        seen["main_while_worker_set"] = tops.act_storage_mode()
        release.set()
        t.join()
        seen["main_inside"] = tops.act_storage_mode()
    assert seen == {"worker_before": None, "worker_inside": "fp8_e5m2",
                    "worker_after": None, "main_while_worker_set": "int8",
                    "main_inside": "int8"}


# -- the hooks in a small TDANetBest ------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(JAX model, float64 JAX params, the port's float64 model, wav)."""
    from tdanet_tpu.models import flat_torch_to_pytree
    jmodel, flat = jax_tdanet_best(CFG, seed=31)
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
    x = 0.3 * np.random.default_rng(5).standard_normal((B, T))
    return jmodel, params, port_tdanet_best(CFG, flat, torch.float64), x


def _jax_forward(jmodel, params, x, mode):
    """JAX's forward in float64, traced under ``mode`` (the JAX flag is
    read at trace time, so each mode gets its own program)."""
    with jax.enable_x64(), jops.act_storage(mode):
        fwd = jax.jit(lambda p, w: jmodel.apply(p, w,
                                                compute_dtype=jnp.float64))
        return np.asarray(fwd(params, jnp.asarray(x)))


def _snr(got, want):
    return 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())


def test_hooks_sit_at_the_jax_landmarks(pair, monkeypatch):
    """Each iteration stores its depth scales, GA's output and its depth
    fusions; the carry is stored after every iteration but the first."""
    _, _, model, x = pair
    calls = []
    real = tbasic.store_activation
    monkeypatch.setattr(tbasic, "store_activation",
                        lambda t: calls.append(tuple(t.shape)) or real(t))
    with torch.no_grad():
        model(torch.from_numpy(x))
    depth, n = CFG["upsampling_depth"], CFG["num_blocks"]
    assert len(calls) == n * (2 * depth + 1) + (n - 1)


def test_off_equals_jax(pair):
    jmodel, params, model, x = pair
    want = _jax_forward(jmodel, params, x, None)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * scale)


# Under a mode both sides quantise the same float64 values, which agree to
# about 1e-15; a value within that distance of an int8 or fp8 rounding
# boundary (a tie) can round to the neighbouring step on one side only,
# and that step then travels on through the remaining iterations. So no
# exact limit holds. On these inputs no value rounds apart (306.8-310.9 dB,
# float64 rounding alone); 60 dB leaves room for a few such steps and lies
# far above a hook at a wrong place or a wrong cast (the modes' own cost
# against off is 18.0-28.3 dB here).
MODE_LIMIT_DB = 60.0


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_jax(pair, mode):
    jmodel, params, model, x = pair
    want = _jax_forward(jmodel, params, x, mode)
    off = _jax_forward(jmodel, params, x, None)
    with torch.no_grad(), tops.act_storage(mode):
        got = model(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert _snr(got, want) >= MODE_LIMIT_DB, (_snr(got, want),
                                              _snr(off, want))
    assert _snr(off, want) < MODE_LIMIT_DB - 10


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3"])
def test_staged_forward_under_a_mode(pair, mode):
    """Stage 1 at depth 2 then stage 2 by one iteration equals the
    depth-3 forward under the same mode, and stage 1's estimate the
    depth-2 forward: the staged forward stores the carries as the forward
    does."""
    _, _, model, x = pair
    xt = torch.from_numpy(x)
    with tops.act_storage(mode):
        with torch.no_grad():
            full = model(xt, per_utterance=True)
            d2 = model(xt, num_blocks=2, per_utterance=True)
        est1, state = model.forward_stage1(xt, 2, per_utterance=True)
        est2 = model.forward_stage2(state, 1, model.pad_rest(T),
                                    per_utterance=True)
    np.testing.assert_array_equal(est1.numpy(), d2.numpy())
    np.testing.assert_array_equal(est2.numpy(), full.numpy())
