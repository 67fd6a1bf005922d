"""The EMCAD-era family's building blocks against the JAX package's, in
float64 on the same perturbed weights of the JAX init, at narrow widths
and B=2: every class of ``models/transxnet.py`` (ConvModule, the
per-sample conv, IDConv, FCDyConv, OSRA with and without reduction and
relative-position table, CrossOSRA, the multi-scale dwconv, MS-FFN in
each activation, LayerScale, the D-Mixer, Block1D) and of
``models/emcad.py`` (channel_shuffle, MSDC, MSCB in each flavour,
MSCBLayer, EUCB, LGAG, LGAG3, CAB, SAB, and each decoder at decoder
level), then the LAOpt fusions and the GA flavours of
``models/tdanet_emcad.py``."""
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close64, jax_apply64, jax_init_flat

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu.models import emcad as jem  # noqa: E402
from tdanet_tpu.models import tdanet_emcad as jte  # noqa: E402
from tdanet_tpu.models import transxnet as jtx  # noqa: E402
from tdanet_tpu_torch.models import emcad as em  # noqa: E402
from tdanet_tpu_torch.models import load_jax_params  # noqa: E402
from tdanet_tpu_torch.models import tdanet_emcad as te  # noqa: E402
from tdanet_tpu_torch.models import transxnet as tx  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _check(jmod, tmod, inputs, seed, jcall=None, tcall=None):
    """The JAX block's apply and the port's forward on the same perturbed
    JAX-init weights and inputs, in float64. ``jcall(jmod, p, *inputs)``
    and ``tcall(tmod, *inputs)`` default to apply(p, *inputs) and the
    forward."""
    flat = jax_init_flat(jmod.init, seed=seed, jit=False)
    jcall = jcall or (lambda m, p, *a: m.apply(p, *a))
    tcall = tcall or (lambda m, *a: m(*a))
    want = jax_apply64(lambda p, *a: jcall(jmod, p, *a), flat, *inputs)
    model = load_jax_params(tmod.double().eval(), flat)
    with torch.no_grad():
        got = tcall(model, *(torch.from_numpy(np.asarray(a))
                             for a in inputs))
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close64(g.numpy(), w)
    else:
        assert_close64(got.numpy(), want)


# -- transxnet.py -------------------------------------------------------------

CONV_MODULES = {
    "dw_k1_norm": dict(in_chans=16, embed_dim=16, kernel_size=1, groups=16,
                       bias=False, norm=True),
    "dw_k7_s4_prelu": dict(in_chans=16, embed_dim=16, kernel_size=7,
                           stride=4, padding=3, groups=16, bias=False,
                           norm=True, act="prelu"),
    "dense_k1_relu": dict(in_chans=16, embed_dim=8, kernel_size=1,
                          norm=True, act="relu"),
    "k3_no_norm_gelu": dict(in_chans=16, embed_dim=16, kernel_size=3,
                            norm=False, act="gelu"),
}


@pytest.mark.parametrize("case", sorted(CONV_MODULES))
def test_conv_module(case):
    kw = CONV_MODULES[case]
    _check(jtx.ConvModule(**kw), tx.ConvModule(**kw), [_randn(1, 2, 16, 37)],
           seed=1)


@pytest.mark.parametrize("K,stride,bias", [(3, 1, True), (5, 2, True),
                                           (5, 2, False)])
def test_dynamic_depthwise_conv(K, stride, bias):
    x, w = _randn(2, 2, 6, 23), _randn(3, 2, 6, K)
    b = _randn(4, 2, 6) if bias else None
    with jax.enable_x64():
        want = np.asarray(jtx.dynamic_depthwise_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b), stride=stride))
    got = tx.dynamic_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), stride=stride)
    assert_close64(got.numpy(), want)


@pytest.mark.parametrize("K,stride,act", [(3, 1, "prelu"), (5, 2, None)])
def test_dynamic_conv1d(K, stride, act):
    kw = dict(dim=16, kernel_size=K, num_groups=2, stride=stride, act=act)
    _check(jtx.DynamicConv1d(**kw), tx.DynamicConv1d(**kw),
           [_randn(5, 2, 16, 41)], seed=2)


def test_fc_dy_conv1d():
    kw = dict(dim=16, in_feat=41, kernel_size=5, num_groups=2, stride=2,
              act=None)
    _check(jtx.FCDyConv1d(**kw), tx.FCDyConv1d(**kw), [_randn(6, 2, 16, 41)],
           seed=3)


@pytest.mark.parametrize("heads,sr,rpe", [(1, 1, False), (2, 4, True),
                                          (4, 1, True)])
def test_osra_attention1d(heads, sr, rpe):
    L = 30
    S = -(-L // sr)
    inputs = [_randn(7, 2, 16, L)] + ([_randn(8, 1, heads, L, S)]
                                      if rpe else [])
    kw = dict(dim=16, num_heads=heads, sr_ratio=sr)
    _check(jtx.Attention1D(**kw), tx.Attention1D(**kw), inputs, seed=4,
           jcall=lambda m, p, x, *r: m.apply(p, x, rpe=r[0] if r else None),
           tcall=lambda m, x, *r: m(x, rpe=r[0] if r else None))


def test_cross_attention1d():
    _check(jtx.CrossAttention1D(16, num_heads=1, sr_ratio=1),
           tx.CrossAttention1D(16, num_heads=1, sr_ratio=1),
           [_randn(9, 2, 16, 40), _randn(10, 2, 16, 5)], seed=5)


def test_multiscale_dwconv1d():
    _check(jtx.MultiScaleDWConv1D(18), tx.MultiScaleDWConv1D(18),
           [_randn(11, 2, 18, 33)], seed=6)


@pytest.mark.parametrize("act", ["relu", "gelu", "prelu"])
def test_mlp1d(act):
    _check(jtx.Mlp1D(16, 32, act=act), tx.Mlp1D(16, 32, act=act),
           [_randn(12, 2, 16, 29)], seed=7)


def test_layer_scale1d():
    _check(jtx.LayerScale1D(16), tx.LayerScale1D(16),
           [_randn(13, 2, 16, 9)], seed=8)


def test_hybrid_token_mixer1d():
    kw = dict(dim=32, kernel_size=3, num_groups=2, num_heads=2, sr_ratio=2)
    _check(jtx.HybridTokenMixer1D(**kw), tx.HybridTokenMixer1D(**kw),
           [_randn(14, 2, 32, 24), _randn(15, 1, 2, 24, 12)], seed=9,
           jcall=lambda m, p, x, r: m.apply(p, x, rpe=r),
           tcall=lambda m, x, r: m(x, rpe=r))


def test_block1d():
    kw = dict(dim=32, kernel_size=3, sr_ratio=4, num_groups=2, num_heads=4,
              mlp_ratio=2, act="relu", drop=0.1, drop_path=0.1)
    _check(jtx.Block1D(**kw), tx.Block1D(**kw),
           [_randn(16, 2, 32, 17), _randn(17, 1, 4, 17, 5)], seed=10,
           jcall=lambda m, p, x, r: m.apply(p, x, rpe=r),
           tcall=lambda m, x, r: m(x, rpe=r))


# -- emcad.py -----------------------------------------------------------------

@pytest.mark.parametrize("groups,times", [(4, 1), (8, 3), (16, 2)])
def test_channel_shuffle(groups, times):
    x = _randn(18, 2, 16, 7)
    with jax.enable_x64():
        want = np.asarray(jem.channel_shuffle(jnp.asarray(x), groups, times))
    assert_close64(em.channel_shuffle(torch.from_numpy(x), groups,
                                      times).numpy(), want)


@pytest.mark.parametrize("parallel,act", [(True, "relu6"), (False, "prelu"),
                                          (True, "gelu")])
def test_msdc(parallel, act):
    args = (16, [1, 3, 5], 1, act, parallel)
    _check(jem.MSDC(*args), em.MSDC(*args), [_randn(19, 2, 16, 31)],
           seed=11)


MSCB_CASES = {
    "add": dict(in_channels=16, out_channels=16, stride=1),
    "concat_out24": dict(in_channels=16, out_channels=24, stride=1,
                         add=False, activation="prelu"),
    "lite_v2_half": dict(in_channels=16, out_channels=16, stride=1,
                         expansion_factor=0.5, activation="prelu",
                         lite_v2=True),
    "stride2": dict(in_channels=16, out_channels=16, stride=2,
                    activation="relu"),
    "serial": dict(in_channels=16, out_channels=16, stride=1,
                   dw_parallel=False, activation="relu"),
}


@pytest.mark.parametrize("case", sorted(MSCB_CASES))
def test_mscb(case):
    kw = MSCB_CASES[case]
    _check(jem.MSCB(**kw), em.MSCB(**kw), [_randn(20, 2, 16, 26)], seed=12)


def test_mscb_layer():
    kw = dict(in_channels=16, out_channels=24, n=2, stride=1,
              expansion_factor=2, activation="prelu")
    _check(jem.MSCBLayer(**kw), em.MSCBLayer(**kw), [_randn(21, 2, 16, 19)],
           seed=13)


@pytest.mark.parametrize("light,shuffle,times,act", [
    (False, True, 1, "relu"), (True, True, 3, "prelu"),
    (True, False, 1, "prelu")])
def test_eucb(light, shuffle, times, act):
    kw = dict(in_channels=16, out_channels=24, activation=act, light=light,
              shuffle=shuffle, shuffle_times=times)
    _check(jem.EUCB(**kw), em.EUCB(**kw), [_randn(22, 2, 16, 11)], seed=14,
           jcall=lambda m, p, x: m.apply(p, x, 21),
           tcall=lambda m, x: m(x, 21))


@pytest.mark.parametrize("kernel,groups,act", [(3, 8, "relu"),
                                               (1, 8, "prelu")])
def test_lgag(kernel, groups, act):
    kw = dict(F_g=16, F_l=16, F_int=8, kernel_size=kernel, groups=groups,
              activation=act)
    _check(jem.LGAG(**kw), em.LGAG(**kw),
           [_randn(23, 2, 16, 25), _randn(24, 2, 16, 25)], seed=15)


def test_lgag3_depthwise_gates():
    """F_int = C = groups: the gates are depthwise K3, #1's sites."""
    kw = dict(F_g=16, F_l=16, F_int=16, kernel_size=3, groups=16,
              activation="prelu")
    tmod = em.LGAG3(**kw)
    assert tmod.W_g.on_kernel and tmod.W_x_bottom.on_kernel
    _check(jem.LGAG3(**kw), tmod,
           [_randn(25, 2, 16, 25), _randn(26, 2, 16, 25),
            _randn(27, 2, 16, 25)], seed=16)


@pytest.mark.parametrize("ratio,act", [(16, "relu"), (32, "prelu")])
def test_cab(ratio, act):
    """At in 16, ratio 32 falls back to the channel count."""
    _check(jem.CAB(16, 16, ratio=ratio, activation=act),
           em.CAB(16, 16, ratio=ratio, activation=act),
           [_randn(28, 2, 16, 13)], seed=17)


@pytest.mark.parametrize("kernel", [3, 7, 11])
def test_sab(kernel):
    _check(jem.SAB(kernel), em.SAB(kernel), [_randn(29, 2, 16, 13)], seed=18)


DECODERS = ["EMCAD", "EMCADNoInit", "EMCADF1", "EMCADTest", "EMCADv1_6",
            "EMCADv1_6_noASG", "EMCADv1_6_noCBAM", "EMCADv1_6_noMMLP",
            "EMCADv1_6_Final"]


@pytest.mark.parametrize("name", DECODERS)
def test_emcad_decoder(name):
    """The decoder alone over a 5-scale pyramid (skips fine -> coarse, the
    coarsest global feature): every stage output, or the finest."""
    kw = dict(channels=[16] * 5, expansion_factor=0.5, activation="prelu")
    lengths = (40, 20, 10, 5, 3)
    inputs = [_randn(30, 2, 16, 3)] + [_randn(31 + i, 2, 16, n)
                                       for i, n in enumerate(lengths)]
    _check(getattr(jem, name)(**kw), getattr(em, name)(**kw), inputs,
           seed=19 + DECODERS.index(name),
           jcall=lambda m, p, x, *s: m.apply(p, x, list(s)),
           tcall=lambda m, x, *s: m(x, list(s)))


def test_emcad_decoder_needs_five_stages():
    with pytest.raises(ValueError, match="5-stage"):
        em.EMCADv1_6(channels=[16] * 4)


# -- tdanet_emcad.py ----------------------------------------------------------

@pytest.mark.parametrize("name,T_g", [
    ("LAOpt1", 13), ("LAOpt1", 7), ("LAOpt2", 13), ("LAOpt2", 7),
    ("LAOpt3", 13), ("LAOpt3", 7), ("LAOpt4", 13), ("LAOpt5", 13)])
def test_laopt(name, T_g):
    """x_l of 25 frames against x_g of 13, the next scale's, and for the
    nearest-upsampling gates of 7 too (LAOpt4/5's stride-2 transposed conv
    needs the next scale: 2 T_g + 1 >= 25)."""
    _check(getattr(jte, name)(16, 16, 5), getattr(te, name)(16, 16, 5),
           [_randn(40, 2, 16, 25), _randn(41, 2, 16, T_g)], seed=30)


GA_CASES = {
    "ffn": dict(drop_path=0.1, attn="none", mlp="ffn"),
    "mha": dict(drop_path=0.1, attn="mha", mlp="ffn"),
    "osra_rpe": dict(drop_path=0.1, attn="osra", mlp="ffn", num_heads=4,
                     sr_ratio=1),
    "ms_ffn": dict(attn="none", mlp="msffn"),
}


@pytest.mark.parametrize("case", sorted(GA_CASES))
def test_ga_era(case):
    """B=2: the unfixed MHA mixes the rows in both packages."""
    kw = GA_CASES[case]
    rpe = [_randn(42, 1, 4, 9, 9)] if kw["attn"] == "osra" else []
    _check(jte.GAEra(16, norm="gn", **kw), te.GAEra(16, norm="gn", **kw),
           [_randn(43, 2, 16, 9)] + rpe, seed=31,
           jcall=lambda m, p, x, *r: m.apply(p, x, rpe=r[0] if r else None),
           tcall=lambda m, x, *r: m(x, rpe=r[0] if r else None))


def test_feat_len_ladder_and_for():
    assert te.feat_len_ladder(134, 5) == jte.feat_len_ladder(134, 5) \
        == [134, 67, 34, 17, 9]
    for T, ms, sr in ((1000, 4, 8000), (32768, 4, 16000), (24000, 4, 8000),
                      (12345, 2, 16000)):
        assert te.feat_len_for(T, ms, sr) == jte.feat_len_for(T, ms, sr)
