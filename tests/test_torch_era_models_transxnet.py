"""The EMCAD-era family against the JAX package, third part: the
TransXNet-flavoured models (IDConv alone, the OSRA gate with its learned
relative-position table, the channel fusion with the unfixed MHA, the
MS-FFN Block1D, the per-scale cross-attention mixers) and the inline
LGAG3 composition of TDANetEMCADv1_4 (at in 256: its gates' groups are
256), in float64 on the same perturbed weights of the JAX init; then
TDANetEMCADv1_6's gradients against ``jax.grad``, and the static
``feat_len`` pinning the length of the models that need it."""
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    ERA_T, assert_close64, check_era_forward, era_cfg, era_pair,
    jax_apply64)

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import tdanet_tpu_torch.models as tzoo  # noqa: E402

NAMES = ["TDANetEMCADv1_4", "TDANetDynamicDownsample", "TDANetGateOSRA",
         "TDANetChannelFusion", "TDANetMSFFN", "TDANetTranXNet"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_fp64(name):
    check_era_forward(name, seed=40 + NAMES.index(name))


def test_emcad_v1_6_gradients_match_jax_grad():
    """Every parameter's gradient of a weighted sum of the B=2 output,
    through the port's autograd (#1's plain version on the CPU) against
    jax.grad of the JAX class, in float64. TDANetEMCADv1_6 has no dropout
    or drop-path: the gradient is the inference forward's. At 1 block
    concat_block never runs: no gradient in the port, zeros in JAX."""
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    jmodel, flat, model = era_pair("TDANetEMCADv1_6", seed=60)
    rng = np.random.default_rng(60)
    x = rng.standard_normal((2, ERA_T))
    w = rng.standard_normal((2, 2, ERA_T))

    def loss(p, x_, w_):
        return jnp.sum(jmodel.apply(p, x_, compute_dtype=jnp.float64) * w_)

    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        grads = jax.jit(jax.grad(loss))(params, jnp.asarray(x),
                                        jnp.asarray(w))
        want = {k: np.asarray(v)
                for k, v in pytree_to_flat_torch(grads).items()}
    model.zero_grad()
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    got = {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for n, p in model.named_parameters()}
    assert {n for n, p in model.named_parameters() if p.grad is None} == {
        "sm.concat_block.0.weight", "sm.concat_block.0.bias",
        "sm.concat_block.1.weight"}
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for n, g in got.items():
        scale = np.abs(want[n]).max()
        if scale < 1e-9 * top:
            # a structural zero (concat_block; the bias of a conv that a
            # one-channel GroupNorm follows): both sides rounding noise
            assert np.abs(g).max() < 1e-9 * top, n
            continue
        np.testing.assert_allclose(g, want[n], rtol=1e-10,
                                   atol=1e-10 * scale, err_msg=n)


@pytest.mark.parametrize("name", ["TDANetGateOSRA", "TDANetMSFFN",
                                  "TDANetEMCADv1_6_FCDyConv",
                                  "TDANetEMCADv1_6_Final"])
def test_feat_len_pins_the_input_length(name):
    """The RPE tables and FCDyConv's pooling are sized by feat_len: a
    forward at its length runs, one at another length raises, as the JAX
    classes do."""
    model = getattr(tzoo, name)(**era_cfg(name)).eval()
    with torch.inference_mode():
        assert model(torch.zeros(1, ERA_T)).shape == (1, 2, ERA_T)
        with pytest.raises((ValueError, RuntimeError)):
            model(torch.zeros(1, 2 * ERA_T))


def test_gate_osra_relative_position_table_is_read():
    """The learned table enters the scores: another table moves the
    output, in the JAX class and in the port alike."""
    from tdanet_tpu_torch.models import load_jax_params
    jmodel, flat, model = era_pair("TDANetGateOSRA", seed=61)
    key = "sm.unet.relative_pos_enc"
    assert flat[key].shape == (1, 4, 9, 9)  # the coarsest of 134 frames
    x = np.random.default_rng(61).standard_normal((1, ERA_T))
    with torch.no_grad():
        before = model(torch.from_numpy(x)).numpy()
    table = np.random.default_rng(62).standard_normal((1, 4, 9, 9))
    flat2 = dict(flat, **{key: table.astype(np.float32)})
    want = jax_apply64(lambda p, w: jmodel.apply(
        p, w, compute_dtype=jnp.float64), flat2, x)
    load_jax_params(model, flat2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert_close64(got, want)
    assert np.abs(got - before).max() > 1e-3 * np.abs(before).max()
