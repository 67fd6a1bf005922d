"""The port's data-parallel train step (two ranks over gloo, one subprocess
each: ``tests/torch_parallel_worker.py``) against the JAX package's dp-2
step (``make_train_step(mesh=make_mesh(dp=2, ...))`` on two of the
conftest's virtual CPU devices), in float64 on the same weights and global
batch: the loss to 1e-10 relative, every gradient (as the clip sees it)
and every updated parameter to 1e-9 of its largest value.

Dropout is off for the JAX comparison: both sides run their eval-mode
forward inside the train step, as ``tests/test_torch_train.py``'s
lockstep does, or, in one case, their training forward with every
dropout and drop-path rate set to 0 and the recipe's checkpointing
(``remat="scales"``), which recomputes the attention's gather inside the
backward. With dropout on, the 2-rank step is held to the port's
one-process step over the same global batch, within 1e-10: the masks are
the global batch's on every rank. The models: TDANetBest and TDANetYang,
whose attention runs over the batch axis, across the ranks here, and
TDANetOld, whose attention runs over time within a row.
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init_flat, jax_tdanet_best, run_ranks

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu.losses import sdr as jsdr  # noqa: E402
from tdanet_tpu_torch.launch_multihost import free_port  # noqa: E402

WORKER = "tests/torch_parallel_worker.py"
# one block for the JAX comparisons (the compiles dominate), two for the
# port-only steps (the recurrence's second iteration draws its own masks)
CFG = dict(out_channels=16, in_channels=32, num_blocks=1,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
CFG2 = dict(CFG, num_blocks=2)
B, T, LR, SEED = 4, 2000, 1e-3, 11


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Jnp64:
    """jax.numpy with float32 read as float64 (the JAX losses cast to
    float32)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _EvalModeJax:
    """The JAX model with its stochastic layers off inside the real
    make_train_step."""

    def __init__(self, model):
        self._m = model

    def apply(self, params, x, training=True, rng=None, compute_dtype=None):
        return self._m.apply(params, x, training=False,
                             compute_dtype=compute_dtype)


def _batch(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / CFG["sample_rate"]
    src = np.stack([np.stack([
        0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                     + rng.uniform(0, 6)) + 0.02 * rng.standard_normal(T)
        for _ in range(2)]) for _ in range(B)])
    return src.sum(1), src


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, perturbed flat float32 parameters)."""
    import tdanet_tpu.models as jzoo
    cache = {}

    def get(name):
        if name not in cache:
            if name == "TDANetBest":
                cache[name] = jax_tdanet_best(CFG, seed=5)
            else:
                jmodel = getattr(jzoo, name)(**CFG)
                cache[name] = (jmodel, jax_init_flat(jmodel.init, seed=6))
        return cache[name]
    return get


_JAX_PROGRAMS = {}


def _no_drop(obj, seen=None):
    """Every dropout and drop-path rate of a JAX model set to 0, in
    place."""
    seen = set() if seen is None else seen
    if id(obj) in seen or not hasattr(obj, "__dict__"):
        return obj
    seen.add(id(obj))
    for name, v in vars(obj).items():
        if name in ("drop", "dropout", "drop_path") and isinstance(v, float):
            setattr(obj, name, 0.0)
        for item in (v if isinstance(v, (list, tuple)) else
                     v.values() if isinstance(v, dict) else [v]):
            if type(item).__module__.startswith("tdanet_tpu."):
                _no_drop(item, seen)
    return obj


def _jax_dp_step(jmodel, flat, mix, src, monkeypatch, training=False):
    """(loss, gradients, updated parameters) of the JAX package's dp-2
    step, flat and float64; ``training``: the model's training forward
    (its rates as they are) in place of its eval-mode one. The jitted
    gradient and step are kept per model, so a second batch of the same
    shapes compiles nothing."""
    from tdanet_tpu.losses import PITLossWrapper as JPIT
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu.parallel import batch_sharding, make_mesh
    from tdanet_tpu.system import optimizers as jopt
    from tdanet_tpu.system.trainer import create_train_state, make_train_step

    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    with jax.enable_x64():
        if jmodel not in _JAX_PROGRAMS:
            model = jmodel if training else _EvalModeJax(jmodel)
            loss_fn = JPIT(jsdr.pairwise_neg_snr, threshold_byloss=True)
            mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
            tx = jopt.make_optimizer("adam", lr=LR, grad_clip=5.0)
            bsh = batch_sharding(mesh)
            grad = jax.jit(jax.grad(
                lambda p, a, b: loss_fn(model.apply(
                    p, a, training=True, rng=jax.random.PRNGKey(0)), b)),
                in_shardings=(None, bsh, bsh))
            step = make_train_step(model, loss_fn, tx, mesh=mesh,
                                   donate=False)
            _JAX_PROGRAMS[jmodel] = (model, mesh, tx, bsh, grad, step)
        model, mesh, tx, bsh, grad, step = _JAX_PROGRAMS[jmodel]
        params = flat_torch_to_pytree({k: np.asarray(v, np.float64)
                                       for k, v in flat.items()})
        with mesh:
            state = create_train_state(model, tx, params, mesh=mesh)
            xm = jax.device_put(jnp.asarray(mix), bsh)
            xs = jax.device_put(jnp.asarray(src), bsh)
            grads = grad(state.params, xm, xs)
            state, loss = step(state, xm, xs, jax.random.PRNGKey(0))
        flat_of = lambda tree: {k: np.asarray(v) for k, v in  # noqa: E731
                                pytree_to_flat_torch(tree).items()}
        return float(loss), flat_of(grads), flat_of(state.params)


def _port_ranks(tmp_path, name, flat, mix, src, training, cfg=CFG,
                world=2, no_drop=False):
    """Each rank's saved result of the port's step over ``world`` ranks."""
    spec = {"name": name, "cfg": cfg, "flat": flat, "mix": mix, "src": src,
            "training": training, "seed": SEED, "lr": LR,
            "no_drop": no_drop}
    path = str(tmp_path / "spec.pt")
    torch.save(spec, path)
    port = free_port()
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    run_ranks([[WORKER, "step", path, str(port), str(r), str(world),
                outs[r]] for r in range(world)])
    return [torch.load(o, weights_only=False) for o in outs]


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def _check_ranks_agree(ranks):
    """The same loss and, bit for bit, the same parameters on every rank."""
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


def _against_jax(tmp_path, monkeypatch, models, name, mix, src,
                 training=False):
    """The port's 2-rank step against the JAX dp-2 step; ``training``: both
    run their training forward with every rate 0 and the recipe's
    checkpointing."""
    jmodel, flat = models(name)
    cfg = CFG
    if training:
        import tdanet_tpu.models as jzoo
        cfg = dict(CFG, remat="scales")
        jmodel = _no_drop(getattr(jzoo, name)(**cfg))
    loss, grads, params = _jax_dp_step(jmodel, flat, mix, src, monkeypatch,
                                       training)
    ranks = _port_ranks(tmp_path, name, flat, mix, src, training=training,
                        cfg=cfg, no_drop=training)
    _check_ranks_agree(ranks)
    got = ranks[0]
    assert abs(got["loss"] - loss) <= 1e-10 * abs(loss), (got["loss"], loss)
    assert set(got["grads"]) == set(grads)
    for k in grads:
        _close(got["grads"][k].numpy(), grads[k], 1e-9, f"grad {k}")
        _close(got["params"][k].numpy(), params[k], 1e-9, f"param {k}")
    moved = max(float(np.abs(params[k] - np.asarray(flat[k], np.float64))
                      .max()) for k in params)
    assert moved > 1e-4
    return ranks


@pytest.mark.parametrize("name", ["TDANetBest", "TDANetYang", "TDANetOld",
                                  "TDANetBest-training"])
def test_two_rank_step_matches_the_jax_dp_step(tmp_path, monkeypatch,
                                               models, name):
    """``-training``: the training branch, which the eval-mode cases never
    take: the training forward with the recipe's checkpointing
    (``remat="scales"``: the port recomputes each iteration, its gather's
    all-reduce included, inside the backward) and every rate 0, on both
    sides."""
    name, _, training = name.partition("-")
    mix, src = _batch(5 if training else 1)
    _against_jax(tmp_path, monkeypatch, models, name, mix, src,
                 training=bool(training))


def test_threshold_byloss_counts_over_the_global_batch(tmp_path,
                                                       monkeypatch, models):
    """Row 0's targets are the model's own estimates plus a whisper of
    noise, so its loss lies far below -30 dB: rank 0 keeps one of its two
    utterances and rank 1 both. The mean must divide by the global count,
    3, as the JAX step does (a mean of per-rank means would not)."""
    from tdanet_tpu_torch.losses import pairwise_neg_snr
    from torch_port_helpers import port_tdanet_best
    _, flat = models("TDANetBest")
    mix, src = _batch(2)
    model = port_tdanet_best(CFG, flat, torch.float64)
    with torch.no_grad():
        est = model(torch.from_numpy(mix)).numpy()
    rng = np.random.default_rng(3)
    src = src.copy()
    src[0] = est[0] + 1e-4 * est[0].std() * rng.standard_normal(
        est[0].shape)
    pw = pairwise_neg_snr(torch.from_numpy(est), torch.from_numpy(src))
    per_utt = np.stack([min(pw[b, 0, 0] + pw[b, 1, 1],
                            pw[b, 0, 1] + pw[b, 1, 0]) / 2
                        for b in range(B)])
    assert per_utt[0] < -30 < per_utt[1:].min()
    _against_jax(tmp_path, monkeypatch, models, "TDANetBest", mix, src)


def _one_process_step(name, flat, mix, src):
    from tdanet_tpu_torch import models as tzoo
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.system.optimizers import make_optimizer
    from tdanet_tpu_torch.system.trainer import (create_train_state,
                                                 make_train_step)
    model = tzoo.get(name)(**CFG2).double()
    tx = make_optimizer("adam", lr=LR, grad_clip=5.0)
    state = create_train_state(model, tx, flat)
    model.double()
    grads, clip = {}, tx.clip_
    named = [n for n, p in model.named_parameters() if p.requires_grad]

    def record(gs):
        grads.update({n: g.clone() for n, g in zip(named, gs)})
        return clip(gs)
    tx.clip_ = record
    step = make_train_step(model, PITLossWrapper(
        pairwise_neg_snr, threshold_byloss=True), tx)
    _, loss = step(state, torch.from_numpy(mix), torch.from_numpy(src),
                   torch.Generator().manual_seed(SEED))
    return loss.item(), grads, dict(model.named_parameters())


@pytest.mark.parametrize("name", ["TDANetBest", "TDANetOld"])
def test_dropout_masks_are_the_global_batchs(tmp_path, name):
    """Dropout, drop-path and attention-weight dropout on: the 2-rank step
    equals the port's one-process step over the global batch (same
    generator seed) within 1e-10, on each rank; the parameters are equal
    bit for bit on the two ranks."""
    from tdanet_tpu_torch import models as tzoo
    model = tzoo.get(name)(**CFG2).reset_parameters(
        torch.Generator().manual_seed(4))
    flat = {k: v.detach().double().numpy()
            for k, v in model.state_dict().items()}
    mix, src = _batch(3)
    loss, grads, params = _one_process_step(name, flat, mix, src)
    ranks = _port_ranks(tmp_path, name, flat, mix, src, training=True,
                        cfg=CFG2)
    _check_ranks_agree(ranks)
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-10 * abs(loss)
        for k in grads:
            _close(r["grads"][k].numpy(), grads[k].numpy(), 1e-10, k)
            _close(r["params"][k].numpy(), params[k].detach().numpy(),
                   1e-10, k)


def test_unreached_parameters_get_zero_gradients_on_every_rank(tmp_path):
    """TDANetBest's coarsest LA fusion never reaches the loss: its
    parameters are zero-filled before the all-reduce, on both ranks, so
    both ranks' buffers line up and the optimizer sees zeros; every other
    gradient is reached. A random init from each rank's own seed: rank 1
    must step from rank 0's parameters (the broadcast)."""
    mix, src = _batch(4)
    ranks = _port_ranks(tmp_path, "TDANetBest", None, mix, src,
                        training=True, cfg=CFG2)
    _check_ranks_agree(ranks)
    coarsest = f"sm.unet.loc_glo_fus.{CFG['upsampling_depth'] - 1}."
    for r in ranks:
        want = sorted(n for n in r["grads"] if n.startswith(coarsest))
        assert want and r["unreached"] == want
        for n in want:
            assert torch.count_nonzero(r["grads"][n]) == 0, n
