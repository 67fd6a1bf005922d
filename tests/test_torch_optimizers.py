"""The port's optimizers against the JAX package's optax chains, on the
CPU in float64: every one of the JAX package's 32 names (and the earlier
cases of the torch.optim names) over 6 steps, with and without the
global-norm clip and with the learning rate halved before step 4; a resume
through a saved state dict continues bit for bit."""
import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
pytest.importorskip("optax")

from tdanet_tpu.system import optimizers as jopt  # noqa: E402
from tdanet_tpu_torch.system import optimizers as topt  # noqa: E402

NAMES = sorted(jopt._FACTORIES)
LR, STEPS, HALVE_AT = 0.05, 6, 3
# the config's extra keys, passed to every name: each keeps the ones its
# JAX factory honours and drops the rest
EXTRA = {"weight_decay": 1e-2, "betas": (0.8, 0.99)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed=3):
    """Parameters as a model holds them (a zero-initialised bias, a (1,)
    PReLU-like scalar, a conv weight that adafactor factors, a vector) and
    STEPS seeded gradients."""
    rng = np.random.default_rng(seed)
    p0 = {"bias": np.zeros(160), "prelu": np.full(1, 0.25),
          "conv": 0.1 * rng.standard_normal((160, 128, 1)),
          "vec": rng.standard_normal(7)}
    grads = [{k: 3 * rng.standard_normal(v.shape) for k, v in p0.items()}
             for _ in range(STEPS)]
    return p0, grads


def _jax_run(name, clip, kw, p0, grads):
    with jax.enable_x64():
        tx = jopt.make_optimizer(name, lr=LR, grad_clip=clip, **kw)
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        st = tx.init(params)
        for i, g in enumerate(grads):
            if i == HALVE_AT:
                jopt.set_learning_rate(st, LR / 2)
            u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                              params)
            params = {k: params[k] + u[k] for k in params}
        return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's parameters after STEPS, by (name, clip, kw),
    computed once a case."""
    cache = {}

    def get(name, clip, kw):
        key = (name, clip, repr(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_run(name, clip, kw, *_problem())
        return cache[key]
    return get


def _torch_params(p0):
    return {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}


def _torch_steps(spec, opt, ps, grads, start=0):
    for i, g in enumerate(grads, start):
        if i == HALVE_AT:
            topt.set_learning_rate(opt, LR / 2)
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        spec.clip_([p.grad for p in ps.values()])
        opt.step()


def _run_and_compare(name, clip, kw, jax_results):
    want = jax_results(name, clip, kw)
    p0, grads = _problem()
    ps = _torch_params(p0)
    spec = topt.make_optimizer(name, lr=LR, grad_clip=clip, **kw)
    _torch_steps(spec, spec.init(ps.values()), ps, grads)
    for k in p0:
        np.testing.assert_allclose(ps[k].detach().numpy(), want[k], rtol=0,
                                   atol=1e-12, err_msg=f"{name} {k}")
    moved = max(float(np.abs(want[k] - p0[k]).max()) for k in p0)
    assert moved > 1e-5, name  # adadelta moves least: ~1e-4


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("clip", [None, 1.0])
def test_every_name_matches_optax(name, clip, jax_results):
    """Each of the 32 names against the JAX package's make_optimizer chain
    for 6 steps (fp64, 1e-12), the learning rate halved before step 4,
    the config's extra keys given."""
    _run_and_compare(name, clip, EXTRA, jax_results)


OPTIMIZERS = [("adam", {}), ("adam", {"weight_decay": 1e-2}),
              ("adamw", {"weight_decay": 0.05}),
              ("sgd", {"momentum": 0.9, "nesterov": True,
                       "weight_decay": 1e-3}),
              ("sgd", {}), ("adadelta", {}), ("adamax", {})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
@pytest.mark.parametrize("clip", [None, 1.0])
def test_optimizer_matches_optax(name, kw, clip):
    """Each torch.optim-backed name against the JAX package's optax chain
    for 6 steps on random parameters and gradients (fp64, 1e-12)."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 5)), "b": rng.standard_normal(7)}
    grads = [{k: 3 * rng.standard_normal(v.shape) for k, v in p0.items()}
             for _ in range(6)]
    with jax.enable_x64():
        tx = jopt.make_optimizer(name, lr=0.05, grad_clip=clip, **kw)
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        st = tx.init(params)
        for g in grads:
            u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                              params)
            params = {k: params[k] + u[k] for k in params}
    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    spec = topt.make_optimizer(name, lr=0.05, grad_clip=clip, **kw)
    opt = spec.init(ps.values())
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        spec.clip_([p.grad for p in ps.values()])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(ps[k].detach().numpy(),
                                   np.asarray(params[k]), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["rmsprop", "sgd", "adamw"])
def test_honoured_keys_match_optax(name, jax_results):
    """The keys a JAX factory does read (rmsprop's alpha, eps and
    momentum; sgd's momentum and nesterov; adamw's eps) change the update
    as they do there."""
    kw = {"rmsprop": {"alpha": 0.9, "eps": 1e-6, "momentum": 0.5},
          "sgd": {"momentum": 0.8, "nesterov": True},
          "adamw": {"eps": 1e-3, "weight_decay": 0.1}}[name]
    _run_and_compare(name, 1.0, kw, jax_results)


@pytest.mark.parametrize("name", NAMES)
def test_resume_continues_bit_for_bit(name):
    """3 steps, the state dict through torch.save into a fresh optimizer
    over fresh parameters, 3 more: equal bit for bit to 6 uninterrupted
    steps."""
    p0, grads = _problem(seed=5)
    spec = topt.make_optimizer(name, lr=LR, grad_clip=1.0, **EXTRA)
    whole = _torch_params(p0)
    _torch_steps(spec, spec.init(whole.values()), whole, grads)

    first = _torch_params(p0)
    opt = spec.init(first.values())
    _torch_steps(spec, opt, first, grads[:3])
    buf = io.BytesIO()
    torch.save({"params": {k: p.detach() for k, p in first.items()},
                "optimizer": opt.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    second = {k: torch.nn.Parameter(v.clone())
              for k, v in saved["params"].items()}
    opt = spec.init(second.values())
    opt.load_state_dict(saved["optimizer"])
    _torch_steps(spec, opt, second, grads[3:], start=3)
    for k in p0:
        assert torch.equal(second[k].detach(), whole[k].detach()), (name, k)


def test_optimizer_names():
    """The port's names are the JAX package's and none raises; the
    registry takes new names once; the learning rate is set and read."""
    assert set(topt._FACTORIES) == set(jopt._FACTORIES)
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name in NAMES:
        assert isinstance(topt.make_optimizer(name.upper()).init(params),
                          torch.optim.Optimizer)
    with pytest.raises(ValueError, match="Could not interpret"):
        topt.make_optimizer("nonesuch")
    topt.register_optimizer("MySGD", topt._sgd)
    with pytest.raises(ValueError):
        topt.register_optimizer("mysgd", topt._sgd)
    opt = topt.make_optimizer("mysgd", lr=0.1).init(
        [torch.nn.Parameter(torch.zeros(2))])
    topt.set_learning_rate(opt, 0.25)
    assert topt.get_learning_rate(opt) == 0.25
    topt._CUSTOM.pop("mysgd")
