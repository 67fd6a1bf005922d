"""The port's losses against the JAX package's, in float64: values and
gradients at 1e-10 of the largest magnitude, n_src 1-5, every sdr_type,
the three PIT modes, threshold_byloss both ways, and reorder_sources where
the best permutation is unique.

The JAX losses cast their inputs to float32; here they run in float64,
with the module's ``jnp.float32`` read as ``jnp.float64`` (a test-local
stand-in for the module's ``jnp``, the package itself unchanged)."""
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu.losses import pit as jpit  # noqa: E402
from tdanet_tpu.losses import sdr as jsdr  # noqa: E402
from tdanet_tpu.losses import sisnri as jsisnri  # noqa: E402
from tdanet_tpu_torch.losses import pit as tpit  # noqa: E402
from tdanet_tpu_torch.losses import sdr as tsdr  # noqa: E402
from tdanet_tpu_torch.losses import sisnri as tsisnri  # noqa: E402

TOL = 1e-10
SDR_TYPES = ("sisdr", "sdsdr", "snr")

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
    """jax.numpy with float32 read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jsdr, "jnp", _Jnp64())
    with jax.enable_x64():
        yield


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _pair(B, n_src, T, seed, snr_db=None):
    """(ests, targets): random targets, and estimates at a spread of SNRs
    (or all at ``snr_db``)."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((B, n_src, T))
    noise = rng.standard_normal((B, n_src, T))
    if snr_db is None:
        snr_db = rng.uniform(-5, 20, (B, n_src, 1))
    e = t[:, rng.permutation(n_src)] + noise * 10 ** (-np.asarray(snr_db)
                                                       / 20)
    return e, t


def _both(jfn, tfn, *arrays, jit=True):
    """Values and the gradients w.r.t. every array of jfn and tfn on the
    same inputs; the gradient is of sum(out * w) with a seeded w. The JAX
    side is jitted where it can be (eager dispatch is slower here; the
    JAX perm_avg reads its permutations on the host)."""
    wrap = jax.jit if jit else (lambda f: f)
    ja = [jnp.asarray(a) for a in arrays]
    jout = wrap(jfn)(*ja)
    w = np.random.default_rng(1).standard_normal(np.shape(jout))
    jgrads = wrap(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                           argnums=tuple(range(len(arrays)))))(*ja)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = tfn(*ts)
    tgrads = torch.autograd.grad((tout * torch.tensor(w)).sum(), ts)
    return (jout, jgrads), (tout.detach().numpy(),
                            [g.numpy() for g in tgrads])


def _assert_both(j, t):
    _close(t[0], j[0])
    for a, b in zip(t[1], j[1]):
        _close(a, b)


@pytest.mark.parametrize("sdr_type", SDR_TYPES)
@pytest.mark.parametrize("n_src", [1, 2, 3, 4, 5])
def test_pairwise_neg_sdr(x64, sdr_type, n_src):
    e, t = _pair(2, n_src, 300, seed=n_src)
    for zero_mean, take_log in ((True, True), (False, False)):
        kw = dict(sdr_type=sdr_type, zero_mean=zero_mean, take_log=take_log)
        _assert_both(*_both(lambda a, b: jsdr.pairwise_neg_sdr(a, b, **kw),
                            lambda a, b: tsdr.pairwise_neg_sdr(a, b, **kw),
                            e, t))


@pytest.mark.parametrize("sdr_type", SDR_TYPES)
def test_singlesrc_and_multisrc_neg_sdr(x64, sdr_type):
    e, t = _pair(3, 2, 257, seed=7)
    for zero_mean, take_log in ((True, True), (False, True), (True, False)):
        kw = dict(sdr_type=sdr_type, zero_mean=zero_mean, take_log=take_log)
        _assert_both(*_both(lambda a, b: jsdr.singlesrc_neg_sdr(a, b, **kw),
                            lambda a, b: tsdr.singlesrc_neg_sdr(a, b, **kw),
                            e[:, 0], t[:, 0]))
        _assert_both(*_both(lambda a, b: jsdr.multisrc_neg_sdr(a, b, **kw),
                            lambda a, b: tsdr.multisrc_neg_sdr(a, b, **kw),
                            e, t))


def test_named_wrappers_and_factories(x64):
    e, t = _pair(2, 3, 200, seed=3)
    pairs = [(getattr(jsdr, n), getattr(tsdr, n)) for n in (
        "pairwise_neg_sisdr", "pairwise_neg_sdsdr", "pairwise_neg_snr",
        "multisrc_neg_sisdr", "multisrc_neg_sdsdr", "multisrc_neg_snr")]
    pairs += [(jsdr.PairwiseNegSDR("snr", zero_mean=False),
               tsdr.PairwiseNegSDR("snr", zero_mean=False)),
              (jsdr.MultiSrcNegSDR("sdsdr", take_log=False),
               tsdr.MultiSrcNegSDR("sdsdr", take_log=False))]
    for jf, tf in pairs:
        _assert_both(*_both(jf, tf, e, t))
    for name in ("singlesrc_neg_sisdr", "singlesrc_neg_sdsdr",
                 "singlesrc_neg_snr"):
        _assert_both(*_both(getattr(jsdr, name), getattr(tsdr, name),
                            e[:, 1], t[:, 1]))
    jf = jsdr.SingleSrcNegSDR("sisdr", reduction="mean")
    tf = tsdr.SingleSrcNegSDR("sisdr", reduction="mean")
    _assert_both(*_both(jf, tf, e[:, 0], t[:, 0]))


def test_freq_mae_wavl1(x64):
    e, t = _pair(2, 2, 400, seed=11)
    kw = dict(win=64, stride=16)
    _assert_both(*_both(lambda a, b: jsdr.freq_mae_wavl1(a, b, **kw),
                        lambda a, b: tsdr.freq_mae_wavl1(a, b, **kw), e, t))
    assert tsdr.freq_mae_wavl1loss is tsdr.freq_mae_wavl1


_MODES = {  # pit_from -> (JAX loss, port loss)
    "pw_mtx": (jsdr.pairwise_neg_sisdr, tsdr.pairwise_neg_sisdr),
    "pw_pt": (jsdr.singlesrc_neg_snr, tsdr.singlesrc_neg_snr),
    "perm_avg": (jsdr.multisrc_neg_sdsdr, tsdr.multisrc_neg_sdsdr),
}


def _pit_data(n_src, seed):
    """Rows at -10..50 dB: some below -30 dB of loss (SNR > 30 dB), some
    above, so threshold_byloss keeps a strict subset."""
    snr = np.array([45.0, 5.0, 35.0, -2.0])[:, None, None]
    return _pair(4, n_src, 240, seed, snr_db=snr)


def _perm_losses(tw, e, t):
    """(B, n_src!) the loss of every permutation of the estimates."""
    e, t = torch.tensor(e), torch.tensor(t)
    perms = list(itertools.permutations(range(t.shape[1])))
    if tw.pit_from == "perm_avg":
        return np.stack([tw.loss_func(e[:, list(p)], t).numpy()
                         for p in perms], 1)
    pw = tw.loss_func(e, t) if tw.pit_from == "pw_mtx" \
        else tw._pw_losses(e, t)
    return np.stack([np.mean([pw[:, p[i], i].numpy()
                              for i in range(len(p))], 0)
                     for p in perms], 1)


@pytest.mark.parametrize("pit_from", sorted(_MODES))
@pytest.mark.parametrize("n_src", [1, 2, 3, 4, 5])
def test_pit_wrapper(x64, pit_from, n_src):
    """Loss and gradient against the JAX wrapper, both ways of
    threshold_byloss; the reordered estimates where the best permutation
    is unique (it is, on this data: asserted)."""
    jloss, tloss = _MODES[pit_from]
    e, t = _pit_data(n_src, seed=20 + n_src)
    # perm_avg takes the plain mean whatever threshold_byloss says, in both
    # packages: one way is enough there
    for thr in (True, False) if pit_from != "perm_avg" else (True,):
        jw = jpit.PITLossWrapper(jloss, pit_from=pit_from,
                                 threshold_byloss=thr)
        tw = tpit.PITLossWrapper(tloss, pit_from=pit_from,
                                 threshold_byloss=thr)
        _assert_both(*_both(jw, tw, e, t, jit=pit_from != "perm_avg"))
    _, jre = jw(jnp.asarray(e), jnp.asarray(t), return_ests=True)
    _, tre = tw(torch.tensor(e), torch.tensor(t), return_ests=True)
    # the best permutation is unique on every row: its loss is at least
    # 1e-6 below the next permutation's
    if n_src > 1:
        part = np.sort(_perm_losses(tw, e, t), axis=1)
        assert (part[:, 1] - part[:, 0] > 1e-6).all()
    _close(tre.numpy(), np.asarray(jre))


def test_threshold_byloss_with_every_row_below(x64):
    """No row above -30 dB: the plain mean, as the JAX wrapper falls back."""
    e, t = _pair(3, 2, 200, seed=5, snr_db=60.0)
    jw = jpit.PITLossWrapper(jsdr.pairwise_neg_snr, threshold_byloss=True)
    tw = tpit.PITLossWrapper(tsdr.pairwise_neg_snr, threshold_byloss=True)
    (jv, _), (tv, _) = _both(jw, tw, e, t)
    assert float(tv) < -30.0
    _close(tv, jv)


@pytest.mark.parametrize("n_src", [4, 5])
def test_hungarian_matches_factorial_and_jax(x64, n_src):
    """n_src > 3 takes scipy's assignment on the host: its loss equals the
    search over every permutation, and the JAX package's pick."""
    e, t = _pair(3, n_src, 200, seed=40 + n_src)
    pw = tsdr.pairwise_neg_sisdr(torch.tensor(e), torch.tensor(t))
    h_loss, h_idx = tpit.find_best_perm_hungarian(pw)
    f_loss, f_idx = tpit.find_best_perm_factorial(pw)
    _close(h_loss.numpy(), f_loss.numpy())
    j_loss, j_idx = jpit.find_best_perm_hungarian(
        jsdr.pairwise_neg_sisdr(jnp.asarray(e), jnp.asarray(t)))
    _close(h_loss.numpy(), np.asarray(j_loss))
    np.testing.assert_array_equal(h_idx.numpy(), np.asarray(j_idx))


def test_sisnri(x64):
    rng = np.random.default_rng(9)
    mix, est, ref = rng.standard_normal((3, 2, 300))
    _assert_both(*_both(jsisnri.sisnr_improvement,
                        tsisnri.sisnr_improvement, mix, est, ref))
    ests, refs = rng.standard_normal((2, 2, 2, 300))
    jv = jsisnri.SISNRi()(jnp.asarray(mix), jnp.asarray(ests),
                          jnp.asarray(refs))
    tv = tsisnri.SISNRi()(torch.tensor(mix), torch.tensor(ests),
                          torch.tensor(refs))
    _close(tv.numpy(), np.asarray(jv))
