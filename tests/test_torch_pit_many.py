"""Permutation-invariant training above three sources, where the port's
PIT takes scipy's Hungarian assignment on the host: the assignment against
the JAX package's, and a TDANetBest with six sources taking 3 train steps
in lockstep with the JAX package's jitted train step (fp64, the same
permutations, losses within 1e-9 relative, parameters within 1e-8)."""
import numpy as np
import pytest
import scipy.optimize
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu.losses import pit as jpit  # noqa: E402
from tdanet_tpu.losses import sdr as jsdr  # noqa: E402
from tdanet_tpu_torch.losses import pit as tpit  # noqa: E402
from tdanet_tpu_torch.models import TDANetBest, load_jax_params  # noqa: E402
from tdanet_tpu_torch.system import optimizers as topt  # noqa: E402
from tdanet_tpu_torch.system.trainer import (  # noqa: E402
    create_train_state, make_train_step)
from torch_port_helpers import jax_tdanet_best  # noqa: E402

N_SRC = 6
CFG = dict(out_channels=32, in_channels=64, num_blocks=2,
           upsampling_depth=4, enc_kernel_size=4, num_sources=N_SRC,
           sample_rate=8000)
B, T, LR, STEPS = 2, 2000, 1e-3, 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_src", [4, 5, 6])
def test_hungarian_assignment_matches_jax(n_src):
    """The port's Hungarian PIT against the JAX package's on seeded cost
    matrices: the same assignment and minimum loss, which for 4 and 5
    sources is also the factorial search's."""
    rng = np.random.default_rng(n_src)
    pwl = rng.standard_normal((8, n_src, n_src))
    with jax.enable_x64():
        jloss, jidx = jpit.find_best_perm_hungarian(jnp.asarray(pwl))
        jloss, jidx = np.asarray(jloss), np.asarray(jidx)
    loss, idx = tpit.find_best_perm(torch.from_numpy(pwl))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-15)
    if n_src <= 5:
        floss, fidx = tpit.find_best_perm_factorial(torch.from_numpy(pwl))
        np.testing.assert_array_equal(fidx.numpy(), idx.numpy())
        np.testing.assert_allclose(floss.numpy(), loss.numpy(), rtol=1e-14)


class _Jnp64:
    """jax.numpy with float32 read as float64 (the JAX losses cast to
    float32; the lockstep runs them in float64)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _EvalModeJax:
    """The JAX model with its stochastic layers off."""

    def __init__(self, model):
        self._m = model

    def apply(self, params, x, training=True, rng=None, compute_dtype=None):
        return self._m.apply(params, x, training=False,
                             compute_dtype=compute_dtype)

    def init(self, key):
        return self._m.init(key)


def _batches():
    """Six tones of distinct seeded frequencies and phases per utterance
    with a little noise: no two pairings tie."""
    rng = np.random.default_rng(11)
    t = np.arange(T) / CFG["sample_rate"]
    out = []
    for _ in range(STEPS):
        src = np.stack([np.stack([
            rng.uniform(0.1, 0.4) * np.sin(
                2 * np.pi * rng.uniform(80, 1200) * t + rng.uniform(0, 6))
            + 0.02 * rng.standard_normal(T) for _ in range(N_SRC)])
            for _ in range(B)])
        out.append((src.sum(1), src))
    return out


def test_six_sources_step_in_lockstep_with_the_jax_train_step(monkeypatch):
    """3 steps of make_train_step (Adam, clip 5, PIT neg-SNR with
    threshold_byloss) on a 6-source TDANetBest against the JAX package's
    jitted step from the same weights: every Hungarian assignment equal,
    losses within 1e-9 relative, parameters within 1e-8."""
    from tdanet_tpu.losses import PITLossWrapper as JPIT
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu.system import optimizers as jopt
    from tdanet_tpu.system.trainer import create_train_state as jcreate
    from tdanet_tpu.system.trainer import make_train_step as jmake
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    assignments = []
    real = scipy.optimize.linear_sum_assignment

    def recording(cost):
        rows, cols = real(cost)
        assignments.append(np.asarray(cols).copy())
        return rows, cols
    monkeypatch.setattr(scipy.optimize, "linear_sum_assignment", recording)
    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    jmodel, flat = jax_tdanet_best(CFG, seed=4)
    batches = _batches()
    with jax.enable_x64():
        jtx = jopt.make_optimizer("adam", lr=LR, grad_clip=5.0)
        params = flat_torch_to_pytree({k: np.asarray(v, np.float64)
                                       for k, v in flat.items()})
        jstate = jcreate(_EvalModeJax(jmodel), jtx, params)
        jstep = jmake(_EvalModeJax(jmodel), JPIT(jsdr.pairwise_neg_snr,
                                                 threshold_byloss=True),
                      jtx, donate=False)
        jlosses = []
        for i, (mix, src) in enumerate(batches):
            jstate, loss = jstep(jstate, jnp.asarray(mix), jnp.asarray(src),
                                 jax.random.PRNGKey(i))
            jlosses.append(float(loss))
        jflat = {k: np.asarray(v) for k, v in
                 pytree_to_flat_torch(jstate.params).items()}
    jassign = assignments[:]
    assert len(jassign) == STEPS * B
    del assignments[:]

    model = load_jax_params(TDANetBest(**CFG).double(), flat)
    tx = topt.make_optimizer("adam", lr=LR, grad_clip=5.0)
    state = create_train_state(model, tx, None)
    step = make_train_step(
        lambda mix, training, generator, compute_dtype: model(mix),
        PITLossWrapper(pairwise_neg_snr, threshold_byloss=True), tx)
    for i, (mix, src) in enumerate(batches):
        state, loss = step(state, torch.from_numpy(mix),
                           torch.from_numpy(src), None)
        assert abs(loss.item() - jlosses[i]) <= 1e-9 * abs(jlosses[i]), i
    assert len(assignments) == len(jassign)
    for got, want in zip(assignments, jassign):
        np.testing.assert_array_equal(got, want)
    # the network does not start at the identity assignment everywhere
    assert any((a != np.arange(N_SRC)).any() for a in jassign)
    moved = 0.0
    for k, v in model.state_dict().items():
        if k in jflat:
            np.testing.assert_allclose(v.numpy(), jflat[k], rtol=0,
                                       atol=1e-8, err_msg=k)
            moved = max(moved, float(np.abs(jflat[k] - flat[k]).max()))
    assert moved > 1e-4
