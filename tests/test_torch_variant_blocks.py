"""The variant family's blocks against the JAX package's, in float64 on
the same perturbed weights: UConvBlockInject for each switch (conv-pool,
the sigmoid gate, the "next" expansion pair, stride 16 with 1-frame
scales, no attention, each MHA flavour), GatedRecurrent; the kernel
routing of the GroupNorm ConvNorms and #1's call count per forward of
every class; TDANetAttn's options; a checkpoint the JAX package
serialized for each class, read strictly by from_pretrain, TDANetYang's
also through ``separate`` and the inference CLI; a 3-step training
lockstep of TDANetNoDrop against the JAX train step."""
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init_flat

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import tdanet_tpu_torch.models as tzoo  # noqa: E402
from tdanet_tpu_torch.models import components, load_jax_params  # noqa: E402
from tdanet_tpu_torch.ops import basic as ops  # noqa: E402

SR = 8000
CFG = dict(out_channels=64, in_channels=128, num_blocks=2,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(got, want, rtol=RTOL):
    got = np.asarray(got)
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _jax64(fn, flat, x):
    """fn(params, x) in float64 under jit, on the flat parameters."""
    from tdanet_tpu.models import flat_torch_to_pytree
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        return np.asarray(jax.jit(fn)(params, jnp.asarray(x)))


# -- blocks -----------------------------------------------------------------

BLOCK_CASES = {
    "default": dict(),
    "pool_conv": dict(pool="conv"),
    "gate_next_batch_first_self_residual": dict(
        inject="gate", expand_pair="next",
        mha_kwargs=dict(batch_first=True, self_residual=True)),
    "stride16_no_attn_depth5": dict(down_stride=16, ga_use_attn=False,
                                    upsampling_depth=5),
    "fixed_mha": dict(fixed_mha=True),
    "next_unfixed_self_residual": dict(
        expand_pair="next",
        mha_kwargs=dict(batch_first=False, self_residual=True)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_uconv_block_inject_matches_jax(case):
    """B=2, T=600 frames (stride 16 at depth 5: 600, 38, 3, 1, 1 frames,
    the coarsest sites 1 frame long)."""
    from tdanet_tpu.models.components import UConvBlockInject as J
    kw = {"upsampling_depth": 4, **BLOCK_CASES[case]}
    jblk = J(16, 32, norm="gn", **kw)
    flat = jax_init_flat(jblk.init, seed=len(case))
    blk = load_jax_params(
        components.UConvBlockInject(16, 32, norm="gn", **kw).double().eval(),
        flat)
    x = np.random.default_rng(1).standard_normal((2, 16, 600))
    want = _jax64(lambda p, x_: jblk.apply(p, x_), flat, x)
    with torch.inference_mode():
        got = blk(torch.from_numpy(x)).numpy()
    _assert_close(got, want)
    assert ("globalatt.attn.attn.in_proj_weight" in flat) == \
        kw.get("ga_use_attn", True)


def test_gated_recurrent_matches_jax():
    """The gates' GroupNorm eps 1e-6, the PReLU on the unet's input, the
    unread parameters kept for the checkpoint."""
    from tdanet_tpu.models.components import GatedRecurrent as JG
    from tdanet_tpu.models.components import UConvBlockInject as JB
    jrec = JG(16, 32, 3, _iter=3, block=JB(16, 32, 3, norm="gn"))
    flat = jax_init_flat(jrec.init, seed=5)
    rec = components.GatedRecurrent(
        16, components.UConvBlockInject(16, 32, 3, norm="gn"), _iter=3)
    rec = load_jax_params(rec.double().eval(), flat)
    assert rec.reset_gate_norm.eps == 1e-6
    assert {"output_norm.weight", "concat_block.0.weight",
            "output_conv_x.weight"} <= set(flat)
    x = np.random.default_rng(2).standard_normal((2, 16, 300))
    want = _jax64(lambda p, x_: jrec.apply(p, x_), flat, x)
    with torch.inference_mode():
        got = rec(torch.from_numpy(x)).numpy()
    _assert_close(got, want)


@pytest.mark.parametrize("norm", ["gln", "gn"])
def test_norm_act_matches_jax(norm):
    """NormAct: the norm's parameter names per flavour, then PReLU."""
    from tdanet_tpu.models.components import NormAct as J
    jm = J(16, norm=norm)
    flat = jax_init_flat(jm.init, seed=6)
    m = load_jax_params(components.NormAct(16, norm=norm).double(), flat)
    x = np.random.default_rng(3).standard_normal((2, 16, 50))
    want = _jax64(lambda p, x_: jm.apply(p, x_), flat, x)
    with torch.no_grad():
        _assert_close(m(torch.from_numpy(x)).numpy(), want)


# -- kernel routing ---------------------------------------------------------

@pytest.fixture()
def counted(monkeypatch):
    """Counts the calls of kernel #1's wrapper that the components make
    (the module-level name they call)."""
    calls = []
    fn = components.dw_conv_glob_ln

    def count(x, *args, stride=1, K=5, **kw):
        calls.append((tuple(x.shape), K, stride))
        return fn(x, *args, stride=stride, K=K, **kw)

    monkeypatch.setattr(components, "dw_conv_glob_ln", count)
    return calls


@pytest.mark.parametrize("K,stride,groups,on_kernel", [
    (5, 1, 32, True), (5, 2, 32, True), (7, 2, 32, True), (1, 1, 32, True),
    (3, 1, 32, True), (33, 16, 32, False), (9, 1, 32, False),
    (5, 4, 32, False), (5, 1, 1, False), (4, 1, 32, False)])
def test_gn_conv_norm_routes_by_its_shape(counted, K, stride, groups,
                                          on_kernel):
    """A GroupNorm ConvNorm goes through #1 exactly where the site is
    depthwise with K odd <= 7 and stride 1 or 2, and gives conv +
    GroupNorm(1, C, eps 1e-8) either way."""
    m = components.ConvNorm(32, 32, K, stride=stride, groups=groups,
                            norm="gn").double()
    torch.nn.init.normal_(m.norm.weight, generator=torch.Generator()
                          .manual_seed(0))
    assert m.on_kernel == on_kernel
    x = torch.randn(2, 32, 97, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = m(x)
        want = ops.group_norm1(
            torch.nn.functional.conv1d(x, m.conv.weight, m.conv.bias,
                                       stride=stride, padding=(K - 1) // 2,
                                       groups=groups),
            m.norm.weight, m.norm.bias)
    assert len(counted) == int(on_kernel)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


FAMILY = ["TDANet", "TDANetAttn", "TDANetChunk", "TDANetGateVariant",
          "TDANetMultRes", "TDANetNoDrop", "TDANetOld", "TDANetOrigin",
          "TDANetULayerNum", "TDANetV2", "TDANetYang"]


@pytest.mark.parametrize("name", FAMILY)
def test_kernel_calls_per_forward_at_depth5(counted, name):
    """At depth 5, #1 runs 17 times a block iteration (the 5 pyramid convs
    and the 4 expansion LAs' 3 depthwise K5 ConvNorms); TDANetULayerNum's
    pyramid convs 1-4 are K33 s16, outside its range: 13."""
    kw = dict(out_channels=8, in_channels=16, num_blocks=3,
              upsampling_depth=5, num_sources=2, sample_rate=SR)
    if name == "TDANetChunk":
        kw["n_chunk"] = 16
    else:
        kw["enc_kernel_size"] = 4
    if name == "TDANetMultRes":
        kw["kernels"] = 4
    model = getattr(tzoo, name)(**kw).eval()
    x = torch.randn(1, 16 * 512, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(x)
    per_iteration = 13 if name == "TDANetULayerNum" else 17
    assert len(counted) == per_iteration * 3
    assert {(K, s) for _, K, s in counted} == (
        {(5, 1)} if name == "TDANetULayerNum" else {(5, 1), (5, 2)})


# -- TDANetAttn's options ----------------------------------------------------

def test_attn_fixed_len_and_stride_match_jax():
    """TDANetAttn's stride reparameterisation and fixed_len centre pad."""
    import tdanet_tpu.models as jzoo
    cfg = dict(CFG, stride=16, fixed_len=300)
    jmodel = jzoo.TDANetAttn(**cfg)
    flat = jax_init_flat(jmodel.init, seed=21)
    model = load_jax_params(tzoo.TDANetAttn(**cfg).double().eval(), flat)
    assert model.encoder.kernel_size == (64,)
    x = np.random.default_rng(22).standard_normal((2, 4001))
    want = _jax64(lambda p, w: jmodel.apply(p, w, compute_dtype=jnp.float64),
                  flat, x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
        with pytest.raises(ValueError, match="longer than"):
            model(torch.zeros(1, 300 * 16))
    _assert_close(got, want)


# -- checkpoint interchange --------------------------------------------------

@pytest.mark.parametrize("name", FAMILY)
def test_jax_serialized_checkpoint_loads_strictly(name, tmp_path):
    """For each class, a .pth the JAX package's serialize() wrote (its
    init's keys and shapes, seeded values) loads through the port's
    from_pretrain into that class, every value equal."""
    import tdanet_tpu.models as jzoo
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu_torch.models import BaseModel
    cfg = dict(CFG, num_blocks=1)
    if name == "TDANetChunk":
        cfg = dict(cfg, n_chunk=20)
        cfg.pop("enc_kernel_size")
    if name == "TDANetMultRes":
        cfg["kernels"] = 4
    jmodel = getattr(jzoo, name)(**cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(FAMILY.index(name))
    flat = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in pytree_to_flat_torch(jax.tree_util.tree_map(
                lambda t: np.zeros(t.shape), shapes)).items()}
    path = str(tmp_path / "model.pth")
    torch.save(jmodel.serialize(flat_torch_to_pytree(flat)), path)
    model = BaseModel.from_pretrain(path)
    assert type(model).__name__ == name
    assert model.get_model_args() == jmodel.get_model_args()
    got = model.state_dict()
    assert set(got) == set(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


def test_jax_serialized_yang_reads_through_from_pretrain(tmp_path):
    """A .pth the JAX package's serialize() wrote for TDANetYang loads
    through the port's from_pretrain (strict) and separates as JAX's
    separate does."""
    import tdanet_tpu.models as jzoo
    from tdanet_tpu.models import flat_torch_to_pytree
    from tdanet_tpu.utils.separator import separate as jax_separate
    from tdanet_tpu_torch.models import BaseModel
    from tdanet_tpu_torch.utils import separate
    jmodel = jzoo.TDANetYang(**CFG, feat_len=100)
    flat = jax_init_flat(jmodel.init, seed=31)
    params = flat_torch_to_pytree(flat)
    path = str(tmp_path / "yang.pth")
    torch.save(jmodel.serialize(params), path)
    model = BaseModel.from_pretrain(path)
    assert isinstance(model, tzoo.TDANetYang) and not model.training
    assert model.get_model_args() == CFG
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(flat[k]))
    wav = np.random.default_rng(4).standard_normal(9000).astype(np.float32)
    want = np.asarray(jax_separate(jmodel, params, wav))
    got = separate(model, wav)
    assert got.shape == want.shape == (2, 9000)
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-4 * np.abs(want).max())


# -- training lockstep --------------------------------------------------------

LOCK_B, LOCK_T, LOCK_LR, LOCK_STEPS = 2, 4000, 1e-3, 3


class _Jnp64:
    """jax.numpy with float32 read as float64 (the JAX losses cast to
    float32; the lockstep runs them in float64)."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_three_step_lockstep_nodrop_with_the_jax_train_step(monkeypatch):
    """TDANetNoDrop has no dropout, so both trainers run their training
    forward (training=True) deterministically: the port's make_train_step
    (Adam, clip 5, PIT neg-SNR) against the JAX package's jitted one,
    from the same weights on the same batches, losses within 1e-9
    relative, parameters within 1e-8."""
    import tdanet_tpu.models as jzoo
    from tdanet_tpu.losses import PITLossWrapper as JPIT
    from tdanet_tpu.losses import sdr as jsdr
    from tdanet_tpu.models import flat_torch_to_pytree, pytree_to_flat_torch
    from tdanet_tpu.system import optimizers as jopt
    from tdanet_tpu.system.trainer import create_train_state as jcreate
    from tdanet_tpu.system.trainer import make_train_step as jmake
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.system import optimizers as topt
    from tdanet_tpu_torch.system.trainer import (create_train_state,
                                                 make_train_step)

    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    jmodel = jzoo.TDANetNoDrop(**CFG)
    flat = jax_init_flat(jmodel.init, seed=41)
    rng = np.random.default_rng(7)
    t = np.arange(LOCK_T) / SR
    batches = []
    for _ in range(LOCK_STEPS):
        src = np.stack([np.stack([
            0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t
                         + rng.uniform(0, 6))
            + 0.02 * rng.standard_normal(LOCK_T) for _ in range(2)])
            for _ in range(LOCK_B)])
        batches.append((src.sum(1), src))
    with jax.enable_x64():
        jtx = jopt.make_optimizer("adam", lr=LOCK_LR, grad_clip=5.0)
        params = flat_torch_to_pytree({k: np.asarray(v, np.float64)
                                       for k, v in flat.items()})
        jstate = jcreate(jmodel, jtx, params)
        jstep = jmake(jmodel, JPIT(jsdr.pairwise_neg_snr,
                                   threshold_byloss=True), jtx, donate=False)
        jlosses = []
        for i, (mix, src) in enumerate(batches):
            jstate, loss = jstep(jstate, jnp.asarray(mix), jnp.asarray(src),
                                 jax.random.PRNGKey(i))
            jlosses.append(float(loss))
        jflat = {k: np.asarray(v) for k, v in
                 pytree_to_flat_torch(jstate.params).items()}

    model = load_jax_params(tzoo.TDANetNoDrop(**CFG).double(), flat)
    tx = topt.make_optimizer("adam", lr=LOCK_LR, grad_clip=5.0)
    state = create_train_state(model, tx, None)
    step = make_train_step(model, PITLossWrapper(pairwise_neg_snr,
                                                 threshold_byloss=True), tx)
    for i, (mix, src) in enumerate(batches):
        state, loss = step(state, torch.from_numpy(mix),
                           torch.from_numpy(src),
                           torch.Generator().manual_seed(i))
        assert abs(loss.item() - jlosses[i]) <= 1e-9 * abs(jlosses[i]), i
    assert state.step == LOCK_STEPS
    assert set(model.state_dict()) == set(jflat)
    moved = 0.0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jflat[k], rtol=0, atol=1e-8,
                                   err_msg=k)
        moved = max(moved, float(np.abs(jflat[k] - flat[k]).max()))
    assert moved > 1e-4  # the parameters did move


def test_inference_cli_runs_the_checkpoints_model(tmp_path):
    """The CLI builds the class the .pth names (here TDANetYang) and
    writes what ``separate`` gives in this process."""
    import os
    import subprocess
    import sys
    from tdanet_tpu_torch.models import BaseModel
    from tdanet_tpu_torch.utils import read_wav, separate, write_wav
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(CFG, num_blocks=1, sample_rate=16000)
    model = tzoo.TDANetYang(**cfg).reset_parameters(
        torch.Generator().manual_seed(2))
    path = str(tmp_path / "yang.pth")
    torch.save(model.serialize(), path)
    wav = np.random.default_rng(6).standard_normal(7777).astype(np.float32)
    mix = str(tmp_path / "mix.wav")
    write_wav(mix, wav * 0.1, 16000)
    out = str(tmp_path / "sep")
    proc = subprocess.run(
        [sys.executable, "-m", "tdanet_tpu_torch.inference", path, mix, out,
         "--device", "cpu"], cwd=repo,
        env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = separate(BaseModel.from_pretrain(path), read_wav(mix)[0])
    for i in (1, 2):
        data, sr = read_wav(f"{out}_s{i}.wav")
        assert sr == 16000 and data.shape == (7777,)
        np.testing.assert_allclose(data, want[i - 1], rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
