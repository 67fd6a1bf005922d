"""The port's training path against the JAX package's, on the CPU in
float64: training mode (dropout, drop-path, seeds, checkpointing), a
5-step lockstep of make_train_step, the schedulers, the
best_model.pth interchange, and AudioTrainer.fit end to end with a
resume."""
import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

from tdanet_tpu.losses import sdr as jsdr  # noqa: E402
from tdanet_tpu_torch.models import TDANetBest, load_jax_params  # noqa: E402
from tdanet_tpu_torch.ops import basic as ops  # noqa: E402
from tdanet_tpu_torch.system import optimizers as topt  # noqa: E402
from tdanet_tpu_torch.system import schedulers as tsched  # noqa: E402
from tdanet_tpu_torch.system.trainer import (  # noqa: E402
    create_train_state, make_train_step)
from torch_port_helpers import jax_tdanet_best  # noqa: E402

TINY = dict(out_channels=16, in_channels=32, num_blocks=3,
            upsampling_depth=4, enc_kernel_size=4, num_sources=2,
            sample_rate=8000)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread a test, so that
    parallel test workers do not oversubscribe the cores (each op's
    parallel region would wait for threads the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



class _Jnp64:
    """jax.numpy with float32 read as float64 (the JAX losses cast to
    float32; the lockstep runs them in float64)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _tiny(seed=0, dtype=torch.float64, **kw):
    model = TDANetBest(**{**TINY, **kw}).to(dtype)
    return model.reset_parameters(torch.Generator().manual_seed(seed))


# -- training mode -------------------------------------------------------

def test_dropout_and_drop_path_keep_the_mean_and_drop_the_share():
    x = torch.ones(64, 8, 512, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    y = ops.dropout(x, gen, 0.1, True)
    share = (y == 0).double().mean().item()
    assert abs(share - 0.1) < 0.005 and abs(y.mean().item() - 1) < 0.01
    assert torch.equal(ops.dropout(x, gen, 0.1, False), x)
    p = ops.drop_path(torch.ones(4000, 3, 5, dtype=torch.float64), gen,
                      0.1, True)
    per_sample = p.flatten(1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.9).all(1)).all()
    assert abs((per_sample[:, 0] == 0).double().mean().item() - 0.1) < 0.02


def test_same_seed_same_masks_and_checkpointed_gradients_equal():
    """The same generator seed gives the same training forward; another
    seed another one; the gradients with per-iteration checkpointing equal
    those without, bit for bit, with dropout on (fp64)."""
    model = _tiny(num_blocks=2)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 2000)))

    def grads(remat, seed):
        model.sm.remat = remat
        model.zero_grad(set_to_none=True)
        out = model(x, training=True,
                    generator=torch.Generator().manual_seed(seed))
        out.square().mean().backward()
        return out.detach(), [p.grad for p in model.parameters()
                              if p.grad is not None]

    out, g = grads(False, 5)
    out2, _ = grads(False, 5)
    out3, _ = grads(False, 6)
    assert torch.equal(out, out2) and not torch.equal(out, out3)
    with torch.no_grad():
        assert not torch.equal(out, model(x))
    for remat in (True, "scales"):
        out_r, g_r = grads(remat, 5)
        assert torch.equal(out_r, out)
        assert len(g_r) == len(g)
        assert all(torch.equal(a, b) for a, b in zip(g_r, g))


def test_one_utterance_attention_is_not_collapsed_in_training(monkeypatch):
    """At B = 1 the inference forward collapses the batch-axis attention
    to out_proj(v_proj(x)); in training it runs the attention, whose
    weights are dropped, as the JAX package does."""
    calls = []
    real = ops.multi_head_attention

    def spy(*a, **kw):
        calls.append(kw.get("training"))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "multi_head_attention", spy)
    model = _tiny(num_blocks=1)
    x = torch.zeros(1, 4000, dtype=torch.float64)
    with torch.no_grad():
        model(x)
        assert calls == []
        model(x, training=True, generator=torch.Generator().manual_seed(1))
    assert calls == [True]


@pytest.mark.parametrize("L,out", [(80, 634), (80, 159), (14, 110),
                                   (189, 3010), (159, 317)])
def test_nearest_resize_reads_the_jax_rows_in_every_dtype(L, out):
    """The LA's nearest upsample reads the JAX package's rows (the float32
    floor) in fp32 and in float64, with a gradient that sums each row's
    copies."""
    from tdanet_tpu.ops.basic import nearest_idx
    want = nearest_idx(L, out)
    for dtype in (torch.float32, torch.float64):
        x = torch.arange(L, dtype=dtype)[None, None].requires_grad_()
        y = ops.interpolate_nearest(x, out)
        np.testing.assert_array_equal(y.detach()[0, 0].long().numpy(), want)
        y.sum().backward()
        np.testing.assert_array_equal(x.grad[0, 0].numpy(),
                                      np.bincount(want, minlength=L))


def test_compute_dtype_keeps_fp32_master_weights():
    """compute_dtype=bf16: bf16 activations and output, fp32 parameters
    and fp32 gradients; close to the fp32 forward."""
    model = _tiny(dtype=torch.float32, num_blocks=1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 4000)).astype(np.float32))
    out = model(x, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.float().square().mean().backward()
    assert all(p.dtype == torch.float32 and (p.grad is None or
                                             p.grad.dtype == torch.float32)
               for p in model.parameters())
    with torch.no_grad():
        ref = model(x)
    err = (out.detach().float() - ref).square().sum() / ref.square().sum()
    assert err.item() < 1e-3


# -- lockstep against the JAX trainer ------------------------------------

LOCK_CFG = dict(out_channels=64, in_channels=128, num_blocks=2,
                upsampling_depth=4, enc_kernel_size=4, num_sources=2,
                sample_rate=8000)
LOCK_B, LOCK_T, LOCK_LR, LOCK_STEPS = 2, 4000, 1e-3, 5


class _EvalModeJax:
    """The JAX model with its stochastic layers off, so the real
    make_train_step program runs deterministically."""

    def __init__(self, model):
        self._m = model

    def apply(self, params, x, training=True, rng=None, compute_dtype=None):
        return self._m.apply(params, x, training=False,
                             compute_dtype=compute_dtype)

    def init(self, key):
        return self._m.init(key)


def _lockstep_batches():
    rng = np.random.default_rng(7)
    t = np.arange(LOCK_T) / LOCK_CFG["sample_rate"]
    out = []
    for _ in range(LOCK_STEPS):
        src = np.stack([np.stack([
            0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                         + rng.uniform(0, 6))
            + 0.02 * rng.standard_normal(LOCK_T) for _ in range(2)])
            for _ in range(LOCK_B)])
        out.append((src.sum(1), src))
    return out


def test_five_step_lockstep_with_the_jax_train_step(monkeypatch):
    """The port's make_train_step (Adam, clip 5, one set_learning_rate
    midway, PIT neg-SNR with threshold_byloss) against the JAX package's
    jitted make_train_step, from the same weights on the same batches,
    stochastic layers off on both sides: losses within 1e-9 relative,
    parameters within 1e-8."""
    from tdanet_tpu.losses import PITLossWrapper as JPIT
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu.system import optimizers as jopt
    from tdanet_tpu.system.trainer import create_train_state as jcreate
    from tdanet_tpu.system.trainer import make_train_step as jmake
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    jmodel, flat = jax_tdanet_best(LOCK_CFG, seed=2)
    batches = _lockstep_batches()
    with jax.enable_x64():
        jtx = jopt.make_optimizer("adam", lr=LOCK_LR, grad_clip=5.0)
        params = flat_torch_to_pytree({k: np.asarray(v, np.float64)
                                       for k, v in flat.items()})
        jstate = jcreate(_EvalModeJax(jmodel), jtx, params)
        jstep = jmake(_EvalModeJax(jmodel), JPIT(jsdr.pairwise_neg_snr,
                                                 threshold_byloss=True),
                      jtx, donate=False)
        jlosses = []
        for i, (mix, src) in enumerate(batches):
            if i == 2:
                jopt.set_learning_rate(jstate.opt_state, LOCK_LR / 2)
            jstate, loss = jstep(jstate, jnp.asarray(mix), jnp.asarray(src),
                                 jax.random.PRNGKey(i))
            jlosses.append(float(loss))
        jflat = {k: np.asarray(v) for k, v in
                 pytree_to_flat_torch(jstate.params).items()}

    model = load_jax_params(TDANetBest(**LOCK_CFG).double(), flat)
    tx = topt.make_optimizer("adam", lr=LOCK_LR, grad_clip=5.0)
    state = create_train_state(model, tx, None)
    step = make_train_step(
        lambda mix, training, generator, compute_dtype: model(mix),
        PITLossWrapper(pairwise_neg_snr, threshold_byloss=True), tx)
    for i, (mix, src) in enumerate(batches):
        if i == 2:
            topt.set_learning_rate(state.optimizer, LOCK_LR / 2)
        state, loss = step(state, torch.from_numpy(mix),
                           torch.from_numpy(src), None)
        assert abs(loss.item() - jlosses[i]) <= 1e-9 * abs(jlosses[i]), i
    assert state.step == LOCK_STEPS
    moved = 0.0
    for k, v in model.state_dict().items():
        if k in jflat:
            np.testing.assert_allclose(v.numpy(), jflat[k], rtol=0,
                                       atol=1e-8, err_msg=k)
            moved = max(moved, float(np.abs(jflat[k] - flat[k]).max()))
    assert moved > 1e-4  # the parameters did move


# -- schedulers (the optimizers: tests/test_torch_optimizers.py) ----------

def test_schedulers_match_the_jax_classes():
    """DPTNetScheduler.as_list, and ReduceLROnPlateau's learning rates over
    one sequence of validation losses (its cadence: patience, cooldown,
    min_lr), against the JAX classes; state dicts round trip."""
    from tdanet_tpu.system import schedulers as jsched
    kw = dict(steps_per_epoch=7, d_model=64, warmup_steps=20)
    assert tsched.DPTNetScheduler(**kw).as_list(0, 60) == \
        jsched.DPTNetScheduler(**kw).as_list(0, 60)
    losses = [5, 4, 4.5, 4.2, 4.1, 4.3, 3.9, 4.0, 4.0, 4.0, 4.0, 4.0, 3.95,
              3.9, 3.99, 3.98, 4.1, 4.2, 4.3, 4.4]
    pk = dict(patience=2, factor=0.5, cooldown=1, min_lr=1e-4)
    j = jsched.make_scheduler("ReduceLROnPlateau", 2e-3, **pk)
    t = tsched.make_scheduler("ReduceLROnPlateau", 2e-3, **pk)
    jl = [j.step(v) for v in losses]
    tl = [t.step(v) for v in losses]
    assert tl == jl and len(set(tl)) > 2
    t2 = tsched.make_scheduler("ReduceLROnPlateau", 1.0)
    t2.load_state_dict(json.loads(json.dumps(t.state_dict())))
    assert t2.step(5.0) == j.step(5.0)
    assert tsched.make_scheduler("none", 1.0) is None


# -- checkpoints and the trainer -----------------------------------------

def test_best_model_pth_loads_in_the_jax_package(tmp_path):
    """The port's export_torch_pth is read by tdanet_tpu's from_pretrain
    and gives the same fp64 forward (1e-10)."""
    from tdanet_tpu.models import BaseModel as JBase
    from tdanet_tpu_torch.system.checkpoint import export_torch_pth
    model = _tiny(seed=4)
    path = export_torch_pth(model, str(tmp_path / "best_model.pth"))
    x = np.random.default_rng(2).standard_normal((2, 5000))
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    with jax.enable_x64():
        jmodel, params = JBase.from_pretrain(path)
        got = np.asarray(jax.jit(lambda p, w: jmodel.apply(
            p, w, compute_dtype=jnp.float64))(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def _debug_config(tmp_path, data_root, epochs):
    from tdanet_tpu_torch.utils.parser import apply_overrides, load_yaml
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = load_yaml(os.path.join(repo, "configs", "tdanet_debug.yml"))
    return apply_overrides(conf, [
        f"datamodule.data_config.{k}_dir={data_root}/{k}"
        for k in ("train", "valid", "test")] + [
        "audionet.audionet_config.num_blocks=1",
        "audionet.audionet_config.out_channels=64",
        "audionet.audionet_config.in_channels=128",
        "datamodule.data_config.segment=0.5",
        "datamodule.data_config.num_workers=1",
        f"training.epochs={epochs}", "exp.project=null",
        f"main_args.exp_dir={tmp_path}/exp", "main_args.device=cpu"])


def test_audio_trainer_fits_exports_and_resumes(tmp_path, capsys):
    """The CLI on the CPU: 2 epochs of a 1-block TDANetBest (width 64/128)
    on synthetic manifests write the history, the kept best steps and
    best_model.pth (read back by from_pretrain, equal to the trainer's best
    model); a resume runs the next epoch only, with the scheduler's state
    restored."""
    from test_data_metrics_utils import make_synth_split
    from tdanet_tpu_torch import audio_train
    from tdanet_tpu_torch.models import BaseModel
    from tdanet_tpu_torch.utils.parser import save_yaml
    for split in ("train", "valid", "test"):
        make_synth_split(str(tmp_path / "data" / split), n_utt=4,
                         seconds=(0.6, 0.9), seed=len(split))
    conf = _debug_config(tmp_path, tmp_path / "data", epochs=2)
    conf_path = str(tmp_path / "conf.yml")
    save_yaml(conf_path, conf)
    trainer = audio_train.cli(["--conf_dir", conf_path, "--device", "cpu"])
    exp = tmp_path / "exp"
    hist = json.loads((exp / "history.json").read_text())
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(math.isfinite(r["train_loss"]) and math.isfinite(
        r["val_loss"]) for r in hist)
    kept = json.loads((exp / "best_k_models.json").read_text())
    assert sorted(kept["kept_steps"]) == [0, 1]
    assert kept["best_step"] == min(range(2),
                                    key=lambda e: hist[e]["val_loss"])
    assert "Model TDANetBest" in capsys.readouterr().out
    loaded = BaseModel.from_pretrain(str(exp / "best_model.pth"))
    x = torch.randn(1, 4000)
    with torch.no_grad():
        assert torch.equal(loaded(x), trainer.best_model(x))
    extras = json.loads((exp / "extras.json").read_text())
    assert extras["epoch"] == 1 and "scheduler" in extras

    conf = _debug_config(tmp_path, tmp_path / "data", epochs=3)
    conf["main_args"]["resume"] = True
    resumed = audio_train.main(conf)
    assert [r["epoch"] for r in resumed.history] == [2]
    old_best = extras["scheduler"]["best"]
    new = resumed.history[0]["val_loss"]
    assert resumed.scheduler.best == (
        new if new < old_best - 1e-4 * abs(old_best) else old_best)
    assert resumed.state.step == 3 * 2
