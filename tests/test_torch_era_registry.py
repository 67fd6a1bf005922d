"""The EMCAD-era family's 22 classes in the registry and at the
checkpoint boundary, and their kernel routing: every class builds from
its name and separates; its state_dict keys and shapes equal the JAX
init's flat tree; a ``.pth`` the JAX package's ``serialize()`` wrote loads
strictly through ``from_pretrain``; ``reset_parameters`` follows the JAX
init's distributions; #1 runs at exactly the sites the rule names (per
class and block iteration, with each site's eps); ``per_utterance`` rows
of the unfixed-MHA classes equal the rows alone. The one ``gpu`` test
holds a full-width TDANetEMCADv1_6's #1 sites against plain on a card.

JAX is imported inside the tests that need it, so the card test also runs
where JAX is absent:
    python -m pytest --noconftest tests/test_torch_era_registry.py -m gpu
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import ERA_SITES, ERA_T, era_cfg

import tdanet_tpu_torch.models as tzoo
from tdanet_tpu_torch.models import components

NAMES = sorted(ERA_SITES)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_zeros_flat(name, cfg):
    """The JAX class and its init's flat keys -> shapes, from eval_shape."""
    jax = pytest.importorskip("jax")
    import tdanet_tpu.models as jzoo
    from tdanet_tpu.models import pytree_to_flat_torch
    jmodel = getattr(jzoo, name)(**cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    flat = pytree_to_flat_torch(jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, np.float32), shapes))
    return jmodel, {k: np.shape(v) for k, v in flat.items()}


def test_available_models_equal_the_jax_registry():
    """The port registers all 34 separation models of the JAX package."""
    pytest.importorskip("jax")
    import tdanet_tpu.models as jzoo
    assert tzoo.available_models() == jzoo.available_models()
    assert len(tzoo.available_models()) == 34


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_keys_equal_jax_flat_keys(name):
    cfg = era_cfg(name)
    _, want = _jax_zeros_flat(name, cfg)
    got = {k: tuple(v.shape)
           for k, v in getattr(tzoo, name)(**cfg).state_dict().items()}
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_jax_serialized_checkpoint_loads_strictly(name, tmp_path):
    """A .pth the JAX package's serialize() wrote (its init's keys and
    shapes, seeded values; the learned relative-position tables of
    TDANetGateOSRA and TDANetMSFFN among them) loads through the port's
    from_pretrain into that class, every value equal."""
    from tdanet_tpu.models import flat_torch_to_pytree
    from tdanet_tpu_torch.models import BaseModel
    cfg = era_cfg(name)
    jmodel, shapes = _jax_zeros_flat(name, cfg)
    rng = np.random.default_rng(NAMES.index(name))
    flat = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    assert ("sm.unet.relative_pos_enc" in flat) == (
        name in ("TDANetGateOSRA", "TDANetMSFFN"))
    path = str(tmp_path / "model.pth")
    torch.save(jmodel.serialize(flat_torch_to_pytree(flat)), path)
    model = BaseModel.from_pretrain(path)
    assert type(model).__name__ == name
    assert model.get_model_args() == jmodel.get_model_args()
    got = model.state_dict()
    assert set(got) == set(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


@pytest.mark.parametrize("name", [n.lower() for n in NAMES])
def test_registry_model_forward(name):
    """Each class builds from its name with a small config (the path the
    YAML configs take) and gives a finite (B, n_src, T) forward."""
    model = tzoo.get(name)(**era_cfg(tzoo.get(name).__name__))
    model.reset_parameters(torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, ERA_T, generator=torch.Generator().manual_seed(1)) \
        * 0.1
    with torch.inference_mode():
        est = model(x)
    assert est.shape == (2, 2, ERA_T) and torch.isfinite(est).all()
    assert type(model).__name__.lower() == name


@pytest.fixture()
def counted(monkeypatch):
    """The calls of kernel #1's wrapper that the modules make (the
    components' module-level name, through which every site goes)."""
    calls = []
    fn = components.dw_conv_glob_ln

    def count(x, *args, stride=1, K=5, eps=1e-8, **kw):
        calls.append((x.shape[2], K, stride, args[1] is not None, eps))
        return fn(x, *args, stride=stride, K=K, eps=eps, **kw)

    monkeypatch.setattr(components, "dw_conv_glob_ln", count)
    return calls


# of ERA_SITES, the sites at eps 1e-5 a block iteration: MSDC's and EUCB's
# (and the LGAG3 chain's gates of TDANetEMCADv1_4 at in 256)
EMCAD_SITES = {
    "TDANetEMCAD_v1": 19, "TDANetEMCADv1_3": 19, "TDANetEMCADv1_4": 30,
    "TDANetEMCADv1_5": 19, "TDANetEMCAD": 19, "TDANetEMCADF1": 19,
    "TDANetEMCADv1_6_noMMLP": 4}
# (K, stride, bias, eps) of every kind of site
SITE_KINDS = {(5, 1, True, 1e-8), (5, 2, True, 1e-8),  # the conv pyramid
              (5, 1, False, 1e-8),  # the LAs, LAOpt1-3's global_act
              (1, 1, False, 1e-8),  # OSRA's sr K1 ConvModule
              (1, 1, False, 1e-5), (3, 1, False, 1e-5),
              (5, 1, False, 1e-5),  # MSDC; EUCB's K3
              (3, 1, True, 1e-5)}   # the LGAG3 chain's gates at in 256


@pytest.mark.parametrize("name", NAMES)
def test_kernel_sites_per_block_iteration(counted, name):
    """#1's calls per forward are the class's sites a block iteration
    times the blocks: the conv pyramid's 5, the LAs' 3 each, LAOpt1-3's
    global_act, MSDC's K 1/3/5 and EUCB's K3 depthwise convs (eps 1e-5,
    no bias), OSRA's K1 sr conv (TDANetMSFFN), and at in 256 the LGAG3
    chain's gates of TDANetEMCADv1_4."""
    model = getattr(tzoo, name)(**era_cfg(name, num_blocks=3)).eval()
    with torch.inference_mode():
        model(torch.zeros(1, ERA_T))
    assert len(counted) == 3 * ERA_SITES[name]
    kinds = {(K, s, bias, eps) for _, K, s, bias, eps in counted}
    assert kinds <= SITE_KINDS
    emcad = "v1_6" in name and name != "TDANetEMCADv1_6_noMMLP"
    assert sum(eps == 1e-5 for *_, eps in counted) == 3 * EMCAD_SITES.get(
        name, 10 if emcad else 0)


@pytest.mark.parametrize("name", NAMES)
def test_probe_site_table_at_full_width(counted, name):
    """The chip probe's table (``era.SITES``, which phase 24 asserts) is
    what a block iteration calls at its widths: in 512, out 128."""
    from tdanet_tpu_torch.probes import era
    cfg = era_cfg(name, in_channels=512, out_channels=128)
    model = getattr(tzoo, name)(**cfg).eval()
    with torch.inference_mode():
        model(torch.zeros(1, ERA_T))
    assert len(counted) == era.SITES[name]


def test_capture_step_keeps_each_site_and_its_gradient():
    """Phase 25's precision check (``era.capture_step``) records every #1
    site of one step with the gradient that reached its output, in x's
    layout, and leaves the step's gradients as they are; on the CPU #1 is
    its plain version, so ``check_step_operands`` finds the two equal."""
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.probes import era, train_step
    name = "TDANetEMCADv1_6"
    model = getattr(tzoo, name)(**era_cfg(name, num_blocks=2))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.sm.remat = False
    rng = np.random.default_rng(0)
    src = torch.from_numpy(
        0.1 * rng.standard_normal((2, 2, ERA_T)).astype(np.float32))
    mix = src.sum(1)
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    grads, sites = era.capture_step(model, loss_fn, mix, src)
    assert len(sites) == 2 * ERA_SITES[name]
    for x, _, stride, _, _, dy in sites:
        assert dy.shape == (x.shape[0], (x.shape[1] - 1) // stride + 1,
                            x.shape[2])
        assert dy.stride(1) == 1 and x.stride(1) == 1
    _, ref = train_step.loss_and_grads(model, loss_fn, mix, src)
    assert grads.keys() == ref.keys()
    assert all(torch.equal(grads[n], ref[n]) for n in ref)
    table = era.check_step_operands(sites, "CPU")
    assert all(k == p for rows in table.values()
               for k, p, _ in rows.values())


def test_kinks_replay_the_recorded_side():
    """``train_step.Kinks`` records the side of each activation kink and
    each channel max a step takes; a replay in the same dtype is the same
    step bit for bit with no flips, and a replay that puts one PReLU
    element on the other side moves that element's gradient by (1 -
    slope) x its output gradient, as a flip of fp32 rounding does."""
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.probes import train_step
    name = "TDANetEMCADv1_6"
    model = getattr(tzoo, name)(**era_cfg(name))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.sm.remat = False
    rng = np.random.default_rng(1)
    src = torch.from_numpy(
        0.1 * rng.standard_normal((2, 2, ERA_T)).astype(np.float32))
    mix = src.sum(1)
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=True)
    rec = train_step.Kinks()
    with rec():
        _, grads = train_step.loss_and_grads(model, loss_fn, mix, src)
    _, plain = train_step.loss_and_grads(model, loss_fn, mix, src)
    assert all(torch.equal(grads[n], plain[n]) for n in plain)
    again = train_step.Kinks(rec.masks)
    with again():
        _, replayed = train_step.loss_and_grads(model, loss_fn, mix, src)
    assert again.calls == len(rec.masks) > 0 and again.flips == 0
    assert all(torch.equal(replayed[n], plain[n]) for n in plain)
    # one element of a lone PReLU on the other side
    x = torch.tensor([[[0.5, -0.25, 1.0]]], requires_grad=True)
    a = torch.tensor([0.2])
    one = train_step.Kinks()
    with one():
        from tdanet_tpu_torch.ops import basic
        (basic.prelu(x, a) * torch.tensor([1.0, 3.0, 1.0])).sum().backward()
    assert x.grad.tolist() == [[[1.0, 0.6000000238418579, 1.0]]]
    side = one.masks[0][0].clone()
    side[0, 0, 1] = True
    x.grad = None
    flipped = train_step.Kinks([(side,)])
    with flipped():
        (basic.prelu(x, a) * torch.tensor([1.0, 3.0, 1.0])).sum().backward()
    assert flipped.flips == 1
    assert x.grad.tolist() == [[[1.0, 3.0, 1.0]]]


def test_site_eps_and_bias_by_module():
    """Where each kind of site takes its eps and bias: the pyramid's
    DilatedConvNorm (bias, 1e-8), the LA ConvNorms (no bias, 1e-8), MSDC
    and EUCB (no bias, 1e-5), OSRA's sr K1 ConvModule (no bias, 1e-8)."""
    from tdanet_tpu_torch.models import emcad as em
    from tdanet_tpu_torch.models import transxnet as tx
    eucb = em.EUCB(16, 16)
    msdc = em.MSDC(16, [1, 3, 5], 1)
    sr1 = tx.Attention1D(16, sr_ratio=4).sr
    pyr = components.DilatedConvNorm(16, 16, 5, 2, groups=16, norm="gn")
    assert eucb.up_dwc.on_kernel and eucb.up_dwc._modules["2"].eps == 1e-5
    assert all(d.on_kernel and d._modules["1"].eps == 1e-5
               and d._modules["0"].bias is None for d in msdc.dwconvs)
    assert not sr1[0].on_kernel and sr1[1].on_kernel  # K7 s4, then K1
    assert sr1[1].conv.bias is None and sr1[1].norm.eps == 1e-8
    assert pyr.on_kernel and pyr.conv.bias is not None
    gate = em.LGAG(32, 32, 16, groups=16)  # groups C/2 over C: grouped
    assert not gate.W_g.on_kernel and not gate.psi.on_kernel


def test_reset_parameters_follows_the_jax_init():
    """Seeded; the dynamic banks trunc-normal 0.02; EMCAD's PReLUs 0.2,
    the others 0.25; the RPE table zeros; LayerScale 1e-5; LAOpt4's
    transposed-conv bound; FCDyConv's pooling bound 1/sqrt(in_feat)."""
    cfg = era_cfg("TDANetMSFFN")
    m1 = tzoo.TDANetMSFFN(**cfg).reset_parameters(
        torch.Generator().manual_seed(3))
    m2 = tzoo.TDANetMSFFN(**cfg).reset_parameters(
        torch.Generator().manual_seed(3))
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    sd = m1.state_dict()
    assert torch.equal(sd["sm.unet.relative_pos_enc"],
                       torch.zeros_like(sd["sm.unet.relative_pos_enc"]))
    ls = sd["sm.unet.globalatt.layer_scale_1.weight"]
    assert torch.equal(ls, torch.full_like(ls, 1e-5))
    bank = sd["sm.unet.globalatt.token_mixer.local_unit.weight"]
    assert 0 < bank.abs().max() <= 0.04 and bank.std() < 0.02
    v16 = tzoo.TDANetEMCADv1_6(**era_cfg("TDANetEMCADv1_6")) \
        .reset_parameters(torch.Generator().manual_seed(4)).state_dict()
    assert torch.equal(v16["sm.unet.emcad.lgag0.activation.weight"],
                       torch.full((1,), 0.2))
    assert torch.equal(v16["sm.unet.proj_1x1.act.weight"],
                       torch.full((1,), 0.25))
    lao = tzoo.TDANetEMCADv1_6_noCBAM_laopt4(
        **era_cfg("TDANetEMCADv1_6_noCBAM_laopt4")).reset_parameters(
        torch.Generator().manual_seed(5)).state_dict()
    w = lao["sm.unet.last_layer.0.global_act.weight"]
    assert 0 < w.abs().max() <= 1 / 3 ** 0.5  # depthwise: fan in 3
    fin = tzoo.TDANetEMCADv1_6_Final(**era_cfg("TDANetEMCADv1_6_Final")) \
        .reset_parameters(torch.Generator().manual_seed(6)).state_dict()
    pool = fin["sm.unet.spp_dw.0.pool.weight"]
    assert pool.shape == (5, 134) and 0 < pool.abs().max() <= 134 ** -0.5


@pytest.mark.parametrize("name", ["TDANetEMCADF1", "TDANetChannelFusion"])
def test_per_utterance_rows_equal_single_rows(name):
    """The unfixed MHA attends over the batch axis; per_utterance=True
    gives each row what it gets alone."""
    model = getattr(tzoo, name)(**era_cfg(name)).double().eval()
    model.reset_parameters(torch.Generator().manual_seed(7))
    x = torch.randn(3, ERA_T, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        batched = model(x, per_utterance=True)
        mixed = model(x)
        alone = torch.cat([model(x[i:i + 1]) for i in range(3)])
    torch.testing.assert_close(batched, alone, rtol=1e-12, atol=1e-12)
    assert (mixed - alone).abs().max() > 1e-6 * alone.abs().max()


@pytest.mark.gpu
def test_cuda_sites_of_emcad_v1_6_match_plain():
    """On a card: a full-width TDANetEMCADv1_6 (in 512, 2 blocks, 16 kHz,
    2 s) runs #1 at every site the rule names (22 a block), and at each
    recorded site shape #1 equals its plain version on random operands
    (max|d| <= 1e-4 max|ref|, the site's eps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tdanet_tpu_torch.kernels.dw_conv_glob_ln import (
        dw_conv_glob_ln, dw_conv_glob_ln_reference)
    from tdanet_tpu_torch.models import feat_len_for
    torch.backends.cudnn.allow_tf32 = False
    T = 32768  # 2 s at 16 kHz on the 1024-sample lattice
    model = tzoo.TDANetEMCADv1_6(
        out_channels=128, in_channels=512, num_blocks=2, upsampling_depth=5,
        enc_kernel_size=4, num_sources=2, sample_rate=16000,
        feat_len=feat_len_for(T, 4, 16000))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    seen, fn = set(), components.dw_conv_glob_ln

    def record(x, w, b, g, be, *, stride=1, K=5, eps=1e-8):
        seen.add((x.shape[0], x.shape[1], x.shape[2], K, stride,
                  b is not None, eps))
        return fn(x, w, b, g, be, stride=stride, K=K, eps=eps)

    before = dw_conv_glob_ln.launches
    components.dw_conv_glob_ln = record
    try:
        with torch.inference_mode():
            out = model(torch.randn(1, T, device="cuda") * 0.1)
    finally:
        components.dw_conv_glob_ln = fn
    torch.cuda.synchronize()
    assert dw_conv_glob_ln.launches - before == 2 * 22
    assert torch.isfinite(out).all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for B, T_, C, K, stride, bias, eps in sorted(seen):
        x = torch.randn(B, C, T_, device="cuda",
                        generator=gen).transpose(1, 2)
        ps = (torch.randn(C, 1, K, device="cuda", generator=gen) * 0.2,
              torch.randn(C, device="cuda", generator=gen) * 0.1 if bias
              else None,
              torch.randn(C, device="cuda", generator=gen),
              torch.randn(C, device="cuda", generator=gen))
        with torch.inference_mode():
            got = dw_conv_glob_ln(x, *ps, stride=stride, K=K, eps=eps)
            want = dw_conv_glob_ln_reference(x, *ps, stride=stride, K=K,
                                             eps=eps)
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), (T_, C, K, err)
