"""The port's TDANet variant family against the JAX package's classes, in
float64 on the same perturbed weights: every class's forward at B=2 (the
batch-axis attention mixes the rows), strict state_dict keys, the
registry, per-utterance rows, training mode. The blocks, the kernel
routing, TDANetAttn's options, a checkpoint the JAX package serialized and
the training lockstep are in ``test_torch_variant_blocks.py``."""
import copy

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init_flat

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import tdanet_tpu_torch.models as tzoo  # noqa: E402
from tdanet_tpu_torch.models import load_jax_params  # noqa: E402

SR = 8000
CFG = dict(out_channels=64, in_channels=128, num_blocks=2,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
# per class: (constructor kwargs beyond CFG, input length)
CASES = {
    "TDANetYang": (dict(feat_len=100), 4000),
    "TDANetOrigin": ({}, 4000),
    "TDANetOld": ({}, 4000),
    "TDANet": (dict(feat_len=100), 4000),
    "TDANetNoDrop": ({}, 4000),
    "TDANetULayerNum": ({}, 4000),
    "TDANetGateVariant": ({}, 4000),
    "TDANetChunk": (dict(n_chunk=20), 4000),
    "TDANetMultRes": (dict(feat_len=100, kernels=4), 4000),
    "TDANetAttn": (dict(feat_len=100), 4000),
    "TDANetV2": ({}, 4000),
}
NAMES = sorted(CASES)
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    cfg = {**CFG, **CASES[name][0]}
    if name == "TDANetChunk":
        cfg.pop("enc_kernel_size")
    return cfg


def _jax_forward(jmodel, flat, x, **kw):
    from tdanet_tpu.models import flat_torch_to_pytree
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        fwd = jax.jit(lambda p, w: jmodel.apply(
            p, w, compute_dtype=jnp.float64, **kw))
        return np.asarray(fwd(params, jnp.asarray(x)))


def _assert_close(got, want, rtol=RTOL):
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model, flat params, port model in float64), built on
    first use."""
    import tdanet_tpu.models as jzoo
    cache = {}

    def get(name):
        if name not in cache:
            cfg = _cfg(name)
            jmodel = getattr(jzoo, name)(**cfg)
            flat = jax_init_flat(jmodel.init, seed=NAMES.index(name))
            model = getattr(tzoo, name)(**cfg).double().eval()
            cache[name] = (jmodel, flat, load_jax_params(model, flat))
        return cache[name]
    return get


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_fp64(pairs, name):
    """B=2: the unfixed MHA attends over the batch axis and mixes the two
    rows, in both packages."""
    jmodel, flat, model = pairs(name)
    x = np.random.default_rng(NAMES.index(name)).standard_normal(
        (2, CASES[name][1]))
    want = _jax_forward(jmodel, flat, x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, CASES[name][1])
    _assert_close(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_equal_jax_flat_keys(name):
    """Strict: the same keys and shapes as the JAX init's flat tree (a
    GroupNorm's weight/bias never read as a GlobLN's gamma/beta)."""
    import tdanet_tpu.models as jzoo
    from tdanet_tpu.models import pytree_to_flat_torch
    cfg = _cfg(name)
    shapes = jax.eval_shape(getattr(jzoo, name)(**cfg).init,
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes)
    want = {k: tuple(v.shape) for k, v in
            pytree_to_flat_torch(zeros).items()}
    got = {k: tuple(v.shape)
           for k, v in getattr(tzoo, name)(**cfg).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("name", ["TDANetYang", "TDANetOld", "TDANetV2"])
def test_per_utterance_rows_equal_single_rows(pairs, name):
    """per_utterance=True gives each row what it gets alone; without it
    the batch-axis attention (Yang, V2) mixes the rows."""
    _, _, model = pairs(name)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((3, 4000)))
    with torch.inference_mode():
        batched = model(x, per_utterance=True)
        mixed = model(x)
        alone = torch.cat([model(x[i:i + 1]) for i in range(3)])
    torch.testing.assert_close(batched, alone, rtol=1e-12, atol=1e-12)
    differs = (mixed - alone).abs().max() > 1e-6 * alone.abs().max()
    assert bool(differs) == (name != "TDANetOld")  # Old attends over T


def test_nodrop_training_forward_equals_eval(pairs):
    _, _, model = pairs("TDANetNoDrop")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 4000)))
    with torch.no_grad():
        train = model(x, training=True,
                      generator=torch.Generator().manual_seed(0))
        plain = model(x)
    assert torch.equal(train, plain)


def test_dropout_differs_in_training(pairs):
    """A class with dropout draws masks from the generator: two seeds give
    two outputs, one seed the same output."""
    _, _, model = pairs("TDANetYang")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 4000)))
    with torch.no_grad():
        a, b, c = (model(x, training=True,
                         generator=torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_multres_kernels_must_divide_out_channels():
    with pytest.raises(AssertionError):
        tzoo.TDANetMultRes(**dict(CFG, out_channels=128))  # kernels=3
    tzoo.TDANetMultRes(**dict(CFG, out_channels=128, kernels=4))


def test_no_early_exit_or_progressive_for_a_variant(pairs):
    """As in the JAX package: a depth override and the staged forward are
    TDANetBest's; asking a variant for them raises TypeError."""
    from tdanet_tpu_torch.progressive import separate_progressive
    from tdanet_tpu_torch.utils import separate, separate_batched
    model = copy.deepcopy(pairs("TDANetYang")[2]).float()
    wav = np.random.default_rng(3).standard_normal(3000).astype(np.float32)
    assert separate(model, wav).shape == (2, 3000)
    assert separate_batched(model, [wav, wav[:2000]])[1].shape == (2, 2000)
    with pytest.raises(TypeError):
        separate(model, wav, num_blocks=1)
    with pytest.raises(TypeError):
        separate_progressive(model, wav[None], depth1=1)


def test_reset_parameters_is_seeded_and_in_jax_bounds():
    m1 = tzoo.TDANetYang(**CFG).reset_parameters(
        torch.Generator().manual_seed(1))
    m2 = tzoo.TDANetYang(**CFG).reset_parameters(
        torch.Generator().manual_seed(1))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    sd = m1.state_dict()
    K, C = m1.enc_kernel_size, m1.enc_num_basis
    assert sd["encoder.weight"].abs().max() <= (6 / ((1 + C) * K)) ** 0.5
    assert torch.equal(sd["ln.weight"], torch.ones(C))
    assert torch.equal(sd["sm.unet.last_layer.0.global_act.norm.bias"],
                       torch.zeros(128))
    w = sd["sm.unet.spp_dw.1.conv.weight"]
    assert 0 < w.abs().max() <= 1 / 5 ** 0.5
    assert torch.equal(sd["sm.unet.proj_1x1.act.weight"],
                       torch.full((1,), 0.25))


# -- the registry ----------------------------------------------------------

REGISTRY_BASE = dict(out_channels=64, in_channels=128, num_blocks=1,
                     upsampling_depth=4, enc_kernel_size=4, num_sources=2,
                     sample_rate=SR, feat_len=258)
REGISTRY_SPECIAL = {
    "tdanetchunk": dict(out_channels=64, in_channels=128, num_blocks=1,
                        upsampling_depth=4, n_chunk=20, num_sources=2,
                        sample_rate=SR),
    "tdanetmultres": dict(REGISTRY_BASE, kernels=4),
    "tdanetulayernum": dict(REGISTRY_BASE, upsampling_depth=2),
}


def test_available_models_lists_the_family_and_best():
    """TDANetBest and this family are registered, and the port's registry
    is the JAX package's: all 34 separation models."""
    import tdanet_tpu.models as jzoo
    names = tzoo.available_models()
    assert {"tdanetbest", *(n.lower() for n in NAMES)} <= set(names)
    assert names == jzoo.available_models() and len(names) == 34


@pytest.mark.parametrize("name", sorted(n.lower() for n in NAMES))
def test_registry_model_forward(name):
    """Each class builds from its name with a small config (the path the
    YAML configs take) and gives a finite (B, n_src, T) forward."""
    cfg = dict(REGISTRY_SPECIAL.get(name, REGISTRY_BASE))
    if name in ("tdanetorigin", "tdanetold", "tdanetnodrop", "tdanetv2",
                "tdanetulayernum", "tdanetgatevariant"):
        cfg.pop("feat_len")  # these take none (it would warn)
    model = tzoo.get(name)(**cfg).reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 2000, generator=torch.Generator().manual_seed(1)) \
        * 0.1
    with torch.inference_mode():
        est = model(x)
    assert est.shape == (2, 2, 2000) and torch.isfinite(est).all()
    assert type(model).__name__.lower() == name
