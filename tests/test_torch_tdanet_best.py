"""The port's TDANetBest against the JAX package's, in float64, on the same
perturbed weights: B=1 (attention collapse), B=2 (attention over the batch
axis, the reference quirk), on- and off-lattice lengths, an early-exit
depth, pyramid depths 5 and 4, and the repaired attention (fixed_mha)."""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

CFG = dict(out_channels=64, in_channels=128, num_blocks=2,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: parallel test workers would otherwise
    oversubscribe the cores (each op's parallel region waiting for threads
    the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jmodel, flat = jax_tdanet_best(CFG, seed=3)
    return jmodel, flat, port_tdanet_best(CFG, flat, torch.float64)


def _jax_forward(jmodel, flat, x, **kw):
    from tdanet_tpu.models import flat_torch_to_pytree
    # one jit of the whole forward compiles faster than eager op by op
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        fwd = jax.jit(lambda p, w: jmodel.apply(
            p, w, compute_dtype=jnp.float64, **kw))
        return np.asarray(fwd(params, jnp.asarray(x)))


def _assert_close(got, want):
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("B,T", [(1, 8000), (2, 8000), (1, 12345),
                                 (2, 12345)])
def test_forward_matches_jax_fp64(pair, B, T):
    jmodel, flat, tmodel = pair
    x = np.random.default_rng(T + B).standard_normal((B, T))
    want = _jax_forward(jmodel, flat, x)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    _assert_close(got, want)


def test_early_exit_matches_jax_fp64(pair):
    jmodel, flat, tmodel = pair
    x = np.random.default_rng(5).standard_normal((1, 9001))
    want = _jax_forward(jmodel, flat, x, num_blocks=1)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), num_blocks=1).numpy()
    _assert_close(got, want)


def test_one_block_model_matches_jax_fp64():
    cfg = dict(CFG, num_blocks=1)
    jmodel, flat = jax_tdanet_best(cfg, seed=4)
    tmodel = port_tdanet_best(cfg, flat, torch.float64)
    x = np.random.default_rng(6).standard_normal((2, 8000))
    want = _jax_forward(jmodel, flat, x)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    _assert_close(got, want)


@pytest.mark.parametrize("B", [1, 2])
def test_depth4_model_matches_jax_fp64(B):
    """upsampling_depth 4, the constructor's default: a shallower pyramid
    moves the expansion's finer-scale pair and the fusion upsample."""
    cfg = dict(CFG, upsampling_depth=4)
    jmodel, flat = jax_tdanet_best(cfg, seed=8)
    tmodel = port_tdanet_best(cfg, flat, torch.float64)
    x = np.random.default_rng(9 + B).standard_normal((B, 8001))
    want = _jax_forward(jmodel, flat, x)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    _assert_close(got, want)


@pytest.fixture(scope="module")
def fixed_pair():
    cfg = dict(CFG, fixed_mha=True)
    jmodel, flat = jax_tdanet_best(cfg, seed=12)
    return jmodel, flat, port_tdanet_best(cfg, flat, torch.float64)


@pytest.mark.parametrize("B", [1, 2])
def test_fixed_mha_matches_jax_fp64(fixed_pair, B):
    """fixed_mha=True: attention over T in every row (no batch-axis
    attention, no B=1 collapse) and the residual normed input + pe +
    attention output. At B=2 the batch-axis form would differ."""
    jmodel, flat, tmodel = fixed_pair
    assert tmodel.sm.unet.globalatt.attn.fixed
    x = np.random.default_rng(13 + B).standard_normal((B, 8000))
    want = _jax_forward(jmodel, flat, x)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
        unfixed = port_tdanet_best(CFG, flat, torch.float64)(
            torch.from_numpy(x)).numpy()
    _assert_close(got, want)
    assert np.abs(unfixed - want).max() > 1e-3 * np.abs(want).max()


def test_remat_is_accepted_and_kept():
    from tdanet_tpu_torch.models import TDANetBest
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # neither flag lands in **unused
        model = TDANetBest(**CFG, remat=True, fixed_mha=False)
    assert model.sm.remat is True
    assert not model.sm.unet.globalatt.attn.fixed


def test_per_utterance_rows_equal_single_rows(pair):
    """per_utterance=True gives each row what it gets alone (the
    semantics JAX's separate_batched gets from vmap)."""
    _, _, tmodel = pair
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 8000)))
    with torch.inference_mode():
        batched = tmodel(x, per_utterance=True)
        for i in range(3):
            alone = tmodel(x[i:i + 1])
            torch.testing.assert_close(batched[i:i + 1], alone, rtol=1e-12,
                                       atol=1e-12)


def test_state_dict_keys_equal_jax_flat_keys(pair):
    _, jflat, tmodel = pair  # the JAX init's keys and shapes, perturbed
    assert set(tmodel.state_dict()) == set(jflat)
    for k, v in tmodel.state_dict().items():
        assert tuple(v.shape) == tuple(jflat[k].shape), k


def test_reset_parameters_is_seeded_and_in_jax_bounds():
    from tdanet_tpu_torch.models import TDANetBest
    m1 = TDANetBest(**CFG).reset_parameters(torch.Generator().manual_seed(1))
    m2 = TDANetBest(**CFG).reset_parameters(torch.Generator().manual_seed(1))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    sd = m1.state_dict()
    # torch-default conv bound 1/sqrt(fan_in), xavier encoder, unit gammas
    assert sd["sm.unet.proj_1x1.conv.weight"].abs().max() <= 1 / np.sqrt(64)
    assert sd["encoder.weight"].abs().max() <= np.sqrt(6 / (33 * 64))
    assert torch.all(sd["sm.unet.spp_dw.0.norm.gamma"] == 1)
    assert torch.all(sd["sm.unet.globalatt.attn.attn.in_proj_bias"] == 0)
    assert torch.all(sd["mask_net.0.weight"] == 0.25)
