"""``Recurrent(remat="scales")``, the trainer's default checkpoint policy,
against the JAX package's: in float64 on the CPU, a small TDANetBest and
TDANetOrigin give the JAX ``remat="scales"`` step's loss and gradients;
a saved-tensor census (``torch.autograd.graph.saved_tensors_hooks``) finds
exactly the landmarks and each iteration's input kept, strictly between
full checkpointing and none; #1's calls per policy are the count the chip
smoke holds; and the 2-rank gloo step under "scales" with dropout on
equals the one-process step."""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init_flat, jax_tdanet_best, run_ranks

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import tdanet_tpu.models as jzoo  # noqa: E402
import tdanet_tpu_torch.models as tzoo  # noqa: E402
from tdanet_tpu_torch.launch_multihost import free_port  # noqa: E402
from tdanet_tpu_torch.models import components, load_jax_params  # noqa: E402
from tdanet_tpu_torch.probes.train_step import expected_launches  # noqa: E402

# two blocks (the second iteration's concat and its own masks), narrow
CFGS = {
    "TDANetBest": dict(out_channels=16, in_channels=32, num_blocks=2,
                       upsampling_depth=4, enc_kernel_size=4,
                       num_sources=2, sample_rate=8000),
    "TDANetOrigin": dict(out_channels=16, in_channels=32, num_blocks=2,
                         upsampling_depth=3, enc_kernel_size=4,
                         num_sources=2, sample_rate=8000),
}
# #1's sites a block iteration (depth pyramid stages + 3 a fusion LA + 3 an
# expansion LA), and those that never reach the loss (TDANetBest's
# coarsest fusion)
SITES = {"TDANetBest": 4 + 3 * 4 + 3 * 3, "TDANetOrigin": 3 + 3 * 2}
DEAD = {"TDANetBest": 3, "TDANetOrigin": 0}
B, T = 2, 2000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model under remat "scales", perturbed flat float32
    parameters), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = dict(CFGS[name], remat="scales")
            if name == "TDANetBest":
                cache[name] = jax_tdanet_best(cfg, seed=8)
            else:
                jmodel = getattr(jzoo, name)(**cfg)
                cache[name] = (jmodel, jax_init_flat(jmodel.init, seed=9))
        return cache[name]
    return get


def port_model(name, flat, remat="scales"):
    model = tzoo.get(name)(**CFGS[name], remat=remat).double()
    return load_jax_params(model, flat)


def batch(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T)), rng.standard_normal((B, 2, T))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_scales_step_matches_the_jax_scales_step(pairs, name, monkeypatch):
    """Loss and every gradient of sum(output * w) under remat "scales",
    the port's against jax.grad of the JAX class under its "scales"
    policy, in float64 with dropout off: within 1e-9 of the largest
    value. The port ran the four checkpointed stages an iteration."""
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    jmodel, flat = pairs(name)
    x, w = batch(3)

    def loss(p, x_, w_):
        return jnp.sum(jmodel.apply(p, x_, compute_dtype=jnp.float64) * w_)

    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        jloss, grads = jax.jit(jax.value_and_grad(loss))(
            params, jnp.asarray(x), jnp.asarray(w))
        want = {k: np.asarray(v)
                for k, v in pytree_to_flat_torch(grads).items()}
    model = port_model(name, flat)
    stages, real = [], components._recomputed
    monkeypatch.setattr(components, "_recomputed",
                        lambda fn, *a: stages.append(fn) or real(fn, *a))
    got_loss = (model(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    got_loss.backward()
    assert len(stages) == 4 * CFGS[name]["num_blocks"]
    assert abs(got_loss.item() - float(jloss)) <= 1e-9 * abs(float(jloss))
    got = {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
           for n, p in model.named_parameters()}
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for n, g in got.items():
        np.testing.assert_allclose(g, want[n], rtol=0, atol=1e-9 * top,
                                   err_msg=n)


def census(sm, x, remat):
    """Bytes of the distinct storages that autograd keeps over one forward
    of the recurrence ``sm`` on ``x`` (parameters excluded), each counted
    once however often it is saved; the backward then runs."""
    sm.remat = remat
    params = {p.untyped_storage().data_ptr() for p in sm.parameters()}
    kept = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            kept[storage.data_ptr()] = storage.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = sm(x)
    out.square().sum().backward()
    return sum(kept.values())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_scales_keeps_the_landmarks_and_each_iterations_input(name):
    """Under "scales" autograd keeps, an iteration, its input (B, out, L)
    and the landmarks: the depth scales (B, in, T_k), GA's output
    (B, in, T_coarsest) and the fusions the expansion reads (every scale
    but the coarsest), 8 bytes an element; under full checkpointing the
    inputs alone. Held exactly, and scales strictly between full and
    none."""
    cfg = CFGS[name]
    model = tzoo.get(name)(**cfg).double().reset_parameters(
        torch.Generator().manual_seed(2))
    L = 250
    x = torch.randn(B, cfg["out_channels"], L, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    scales = [L]
    for _ in range(1, cfg["upsampling_depth"]):
        scales.append((scales[-1] - 1) // 2 + 1)
    C, n, item = cfg["in_channels"], cfg["num_blocks"], 8
    inputs = B * cfg["out_channels"] * L * item
    landmarks = B * C * item * (sum(scales) + scales[-1]
                                + sum(scales) - scales[-1])
    got = {remat: census(model.sm, x, remat)
           for remat in (False, True, "scales")}
    assert got[True] == n * inputs
    assert got["scales"] == n * (inputs + landmarks)
    assert got[True] < got["scales"] < got[False]


@pytest.mark.parametrize("name", sorted(CFGS))
def test_site_calls_per_policy(name, monkeypatch):
    """#1's calls in one forward and in its backward, per policy: none
    runs every site once; full recomputes every site; "scales" skips the
    coarsest fusion, which never reaches the loss, and recomputes each
    live site once: train_step.expected_launches, which the chip smoke
    holds the kernel's launches to."""
    cfg = CFGS[name]
    model = tzoo.get(name)(**cfg).double().reset_parameters(
        torch.Generator().manual_seed(5))
    real, calls = components.dw_conv_glob_ln, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(components, "dw_conv_glob_ln", counted)
    x = torch.from_numpy(batch(6)[0])
    sites = SITES[name] * cfg["num_blocks"]
    dead = DEAD[name] * cfg["num_blocks"]
    for remat in (False, True, "scales"):
        model.sm.remat = remat
        calls[0] = 0
        out = model(x)
        first = calls[0]
        out.square().sum().backward()
        forward, _ = expected_launches(remat, sites, dead,
                                       model.sm.landmarked)
        assert calls[0] == forward, remat
        assert first == (sites - dead if remat == "scales" else sites)


def _port_ranks(tmp_path, name, flat, mix, src, world=2):
    """Each rank's saved result of the port's step over ``world`` gloo
    ranks, dropout on, remat "scales"."""
    spec = {"name": name, "cfg": dict(CFGS[name], remat="scales"),
            "flat": flat, "mix": mix, "src": src, "training": True,
            "seed": 11, "lr": 1e-3, "no_drop": False}
    path = str(tmp_path / "spec.pt")
    torch.save(spec, path)
    port = free_port()
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    run_ranks([["tests/torch_parallel_worker.py", "step", path, str(port),
                str(r), str(world), outs[r]] for r in range(world)])
    return [torch.load(o, weights_only=False) for o in outs]


def _one_process_step(name, flat, mix, src, remat):
    """(loss, gradients as the clip sees them, parameters after the
    step) of the port's one-process step, dropout on."""
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.system.optimizers import make_optimizer
    from tdanet_tpu_torch.system.trainer import (create_train_state,
                                                 make_train_step)
    model = tzoo.get(name)(**CFGS[name], remat=remat).double()
    tx = make_optimizer("adam", lr=1e-3, grad_clip=5.0)
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
                   torch.Generator().manual_seed(11))
    return loss.item(), grads, dict(model.named_parameters())


def test_two_rank_scales_step_equals_the_one_process_step(tmp_path):
    """TDANetBest, whose attention gathers every rank's rows, under remat
    "scales" with dropout on over two gloo ranks: the loss, every
    gradient and every updated parameter equal the one-process step's
    within 1e-10 of the largest value, on each rank, and that step's
    gradients equal, bit for bit, the one-process step's without
    checkpointing; both ranks' parameters equal bit for bit."""
    name = "TDANetBest"
    model = tzoo.get(name)(**CFGS[name]).reset_parameters(
        torch.Generator().manual_seed(12))
    flat = {k: v.detach().double().numpy()
            for k, v in model.state_dict().items()}
    rng = np.random.default_rng(13)
    t = np.arange(T) / 8000
    src = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400, (4, 2, 1)) * t) \
        + 0.02 * rng.standard_normal((4, 2, T))
    mix = src.sum(1)
    loss, grads, params = _one_process_step(name, flat, mix, src, "scales")
    _, plain, _ = _one_process_step(name, flat, mix, src, False)
    assert all(torch.equal(grads[k], plain[k]) for k in grads)
    ranks = _port_ranks(tmp_path, name, flat, mix, src)
    for k, v in ranks[0]["params"].items():
        assert torch.equal(ranks[1]["params"][k], v), k
    for r in ranks:
        assert abs(r["loss"] - loss) <= 1e-10 * abs(loss)
        for k in grads:
            for got, want in ((r["grads"][k], grads[k]),
                              (r["params"][k], params[k].detach())):
                scale = want.abs().max().item()
                assert (got - want).abs().max().item() <= 1e-10 * scale, k
