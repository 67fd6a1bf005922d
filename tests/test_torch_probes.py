"""The port's three studies (``tdanet_tpu_torch/scripts/probe_*.py``)
against the JAX package's scripts, and ``compute_dtype`` of ``separate``
and the progressive functions against their JAX counterparts, on the CPU.
The model is a small TDANetBest (width 32/64, 4 blocks, pyramid depth 3,
8 kHz) with the same perturbed weights on both sides; float64 unless a
test says otherwise."""
import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu_torch import progressive as tprog  # noqa: E402
from tdanet_tpu_torch.models import BaseModel, TDANetBest  # noqa: E402
from tdanet_tpu_torch.models import components  # noqa: E402
from tdanet_tpu_torch.scripts import probe_act_quant_quality as tquant  # noqa: E402,E501
from tdanet_tpu_torch.scripts import probe_early_exit as tearly  # noqa: E402
from tdanet_tpu_torch.scripts import probe_progressive as tprobe  # noqa: E402,E501
from tdanet_tpu_torch.system.checkpoint import export_torch_pth  # noqa: E402
from tdanet_tpu_torch.utils import separator as tsep  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(out_channels=32, in_channels=64, num_blocks=4,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
N, BATCH, D1 = 4, 2, 2
DEPTHS = (4, 3, 2)
# bf16 against fp32 in the port's own bf16 test (test_torch_train.py:
# relative error energy below 1e-3); the same limit holds the port's bf16
# path against JAX's
BF16_SNR_DB = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jscript():
    """The JAX package's ``scripts/probe_early_exit.py``, loaded by path."""
    path = os.path.join(REPO, "scripts", "probe_early_exit.py")
    spec = importlib.util.spec_from_file_location("jax_probe_early_exit",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    """(JAX model, flat f32 params, the port's float64 model)."""
    jmodel, flat = jax_tdanet_best(CFG, seed=41)
    return jmodel, flat, port_tdanet_best(CFG, flat, torch.float64)


@pytest.fixture(scope="module")
def tt():
    return tearly.make_tt(N)


def _params(flat, dtype):
    from tdanet_tpu.models import flat_torch_to_pytree
    return flat_torch_to_pytree({k: np.asarray(v, dtype)
                                 for k, v in flat.items()})


@pytest.fixture(scope="module")
def jax_depth_ests(pair, tt):
    """JAX's estimates of the test set at each depth, in float64, as the
    JAX probe computes them (apply on each row alone at num_blocks=d)."""
    jmodel, flat, _ = pair
    mixes, _ = tt
    out = {}
    with jax.enable_x64():
        params = _params(flat, np.float64)
        for d in DEPTHS:
            single = (lambda d: lambda p, w: jmodel.apply(
                p, w[None], compute_dtype=jnp.float64, num_blocks=d)[0])(d)
            fwd = jax.jit(jax.vmap(single, in_axes=(None, 0)))
            out[d] = np.asarray(fwd(params, jnp.asarray(
                mixes.astype(np.float64))))
    return out


def test_test_set_and_metrics_equal_the_jax_script(jscript):
    mixes, srcs = tearly.make_tt(5)
    jm, js = jscript.make_tt(5)
    np.testing.assert_array_equal(mixes, jm)
    np.testing.assert_array_equal(srcs, js)
    assert mixes.shape == (5, tearly.T) and mixes.dtype == np.float32
    rng = np.random.default_rng(3)
    est = rng.standard_normal((5, 2, 800))
    tgt = rng.standard_normal((5, 2, 800))
    np.testing.assert_array_equal(tearly.sisnr(est, tgt),
                                  jscript.sisnr(est, tgt))
    mix = tgt.sum(1)
    assert tearly.sisnri(est, tgt, mix) == jscript.sisnri(est, tgt, mix)
    # not the generator's tt split: other bands, no length draw first
    from tdanet_tpu_torch.scripts import make_convergence_data as gen
    gmix, _ = gen.utterance(2 * 10 ** 6)
    assert gmix.shape == mixes[0].shape
    assert not np.array_equal(gmix, mixes[0])


def test_depth_rows_equal_jax(pair, tt, jax_depth_ests, jscript):
    """Each depth's SI-SNRi from the port's rows equals JAX's apply at
    num_blocks=d scored by the JAX script, within 1e-6 dB."""
    _, _, model = pair
    mixes, srcs = tt
    rows = tearly.depth_rows(model, mixes, srcs, BATCH, iters=1,
                             depths=DEPTHS)
    assert [r["depth"] for r in rows] == list(DEPTHS)
    for r in rows:
        want = jscript.sisnri(jax_depth_ests[r["depth"]], srcs, mixes)
        assert abs(r["sisnri_db"] - want) < 1e-6, (r, want)
        assert np.isfinite(r["rtfx"]) and r["rtfx"] > 0
    ests = tearly.separate_at_depth(model, mixes, 3, BATCH)
    scale = np.abs(jax_depth_ests[3]).max()
    np.testing.assert_allclose(ests, jax_depth_ests[3], rtol=1e-10,
                               atol=1e-10 * scale)


@pytest.fixture
def x64_eval(monkeypatch):
    """JAX in float64, its progressive module's float32 host arrays too
    (as tests/test_torch_eval.py runs it)."""
    from tdanet_tpu import progressive as jprog

    class _Np64:
        float32 = np.float64

        def __getattr__(self, name):
            return getattr(np, name)

    monkeypatch.setattr(jprog, "np", _Np64())
    with jax.enable_x64():
        yield jprog


def test_progressive_proxy_equals_jax(pair, tt, jax_depth_ests, jscript,
                                      x64_eval):
    """The proxy's delta equals JAX ``separate_progressive``'s, and its
    per-utterance gain the JAX probe's from JAX's estimates."""
    jmodel, flat, model = pair
    mixes, srcs = tt
    gain, delta, _, _ = tprobe.proxy(model, mixes, srcs, D1, BATCH)
    _, info = x64_eval.separate_progressive(
        jmodel, _params(flat, np.float64), mixes, depth1=D1,
        threshold=np.inf, batch_size=BATCH, compute_dtype=jnp.float64)
    np.testing.assert_allclose(delta, info["delta"], rtol=1e-9)

    def pit(e):
        keep = jscript.sisnr(e, srcs).mean(-1)
        swap = jscript.sisnr(e[:, ::-1], srcs).mean(-1)
        return np.maximum(keep, swap)

    want = pit(jax_depth_ests[4]) - pit(jax_depth_ests[D1])
    np.testing.assert_allclose(gain, want, atol=1e-6)


def _count_iterations(monkeypatch):
    """Counts UConvBlock forwards: one a block iteration of a batch."""
    counts = [0]
    real = components.UConvBlock.forward

    def counted(self, *a, **k):
        counts[0] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(components.UConvBlock, "forward", counted)
    return counts


def test_progressive_study_and_its_census(pair, tt, monkeypatch):
    """The study's lines carry the JAX probe's keys with finite values, and
    its census gives the block iterations it ran (each ``(depth, rows)``
    is ``depth`` iterations of ``ceil(rows / batch)`` forwards)."""
    _, _, model = pair
    mixes, srcs = tt
    counts = _count_iterations(monkeypatch)
    lines, census = tprobe.study(model, mixes, srcs, D1, BATCH, iters=1,
                                 quantiles=(0.75, 0.25))
    assert counts[0] == sum(d * -(-rows // BATCH) for d, rows in census)
    keys = [sorted(tprobe.rounded(line)) for line in lines]
    assert keys == [["proxy"], ["fixed"], ["fixed"]] + [sorted(
        ["threshold_q", "threshold", "escalated_frac", "sisnri_db", "rtfx",
         "vs16_db"])] * 2
    assert [line["fixed"]["depth"] for line in lines[1:3]] == [4, D1]
    for line in lines:
        flat = line.get("proxy") or line.get("fixed") or line
        assert all(np.isfinite(v) for v in flat.values()), line
    assert lines[3]["escalated_frac"] <= lines[4]["escalated_frac"]


def test_storage_rows(pair, tt):
    """Off equals the full-depth row; each mode moves SI-SNRi a little."""
    _, _, model = pair
    mixes, srcs = tt
    rows = tquant.storage_rows(model, mixes, srcs, BATCH,
                               compute_dtype=None, depth=4)
    assert [r["storage"] for r in rows] == ["off", "int8", "fp8_e4m3",
                                            "fp8_e5m2"]
    full = tearly.sisnri(tearly.separate_at_depth(model, mixes, 4, BATCH),
                         srcs, mixes)
    assert rows[0]["sisnri_db"] == full
    for r in rows[1:]:
        assert np.isfinite(r["sisnri_db"]) and r["sisnri_db"] != full


def test_probe_clis(tmp_path):
    """The three CLIs on a 16-block checkpoint on the CPU: one JSON line
    a depth, the proxy, the two fixed depths and five thresholds, one a
    storage mode, with the JAX scripts' keys."""
    model = TDANetBest(out_channels=8, in_channels=16, num_blocks=16,
                       upsampling_depth=2, enc_kernel_size=4,
                       num_sources=2, sample_rate=8000)
    ckpt = export_torch_pth(model, str(tmp_path / "best_model.pth"))
    common = ["--ckpt", ckpt, "--n", "2", "--batch", "2", "--device", "cpu"]

    def run(main, *extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main([*common, *extra])
        return [json.loads(line) for line in buf.getvalue().splitlines()]

    early = run(tearly.main, "--iters", "1", "--no-bf16")
    assert [r["depth"] for r in early] == list(tearly.DEPTHS)
    assert all(sorted(r) == ["depth", "rtfx", "sisnri_db"] for r in early)
    prog = run(tprobe.main, "--iters", "1")
    assert len(prog) == 3 + len(tprobe.QUANTILES)
    assert prog[0]["proxy"]["d1"] == 8 and prog[1]["fixed"]["depth"] == 16
    quant = run(tquant.main)
    assert [r["storage"] for r in quant] == ["off", "int8", "fp8_e4m3",
                                             "fp8_e5m2"]
    loaded = BaseModel.from_pretrain(ckpt)
    assert loaded.num_blocks == 16


# -- compute_dtype on separate and the progressive functions ---------------


def _snr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(divide="ignore"):  # inf where the two are equal
        return 10 * np.log10((want ** 2).sum() / ((got - want) ** 2).sum())


@pytest.fixture(scope="module")
def fp32_pair(pair):
    """(JAX model, float32 JAX params, the port's float32 model)."""
    jmodel, flat, _ = pair
    return jmodel, _params(flat, np.float32), port_tdanet_best(
        CFG, flat, torch.float32)


def test_separate_bf16_matches_jax(fp32_pair):
    from tdanet_tpu.utils.separator import separate as jseparate
    jmodel, params, model = fp32_pair
    wav = (0.3 * np.random.default_rng(8).standard_normal((2, 3001))
           ).astype(np.float32)
    want = np.asarray(jseparate(jmodel, params, wav,
                                compute_dtype=jnp.bfloat16), np.float32)
    got = tsep.separate(model, wav, compute_dtype=torch.bfloat16)
    fp32 = tsep.separate(model, wav)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 2, 3001)
    assert _snr(got, want) >= BF16_SNR_DB
    assert _snr(got, fp32) < 80  # the activations did run in bf16


def test_separate_progressive_bf16_matches_jax(fp32_pair, tt):
    from tdanet_tpu.progressive import separate_progressive as jsp
    jmodel, params, model = fp32_pair
    # a length on the stride lattice, so that the stream pads nothing
    mixes = tt[0][:, :6000 // model.lcm * model.lcm]
    want, winfo = jsp(jmodel, params, mixes, depth1=D1, threshold=-1.0,
                      batch_size=BATCH, compute_dtype=jnp.bfloat16)
    got, info = tprog.separate_progressive(
        model, mixes, depth1=D1, threshold=-1.0, batch_size=BATCH,
        compute_dtype=torch.bfloat16)
    assert info["n_escalated"] == winfo["n_escalated"] == N
    assert got.dtype == np.float32 and info["delta"].dtype == np.float32
    assert _snr(got, np.asarray(want, np.float32)) >= BF16_SNR_DB
    assert _snr(info["delta"], np.asarray(winfo["delta"], np.float32)) \
        >= BF16_SNR_DB
    fp32, _ = tprog.separate_progressive(model, mixes, depth1=D1,
                                         threshold=-1.0, batch_size=BATCH)
    assert _snr(got, fp32) < 80
    # the stream runs the same bf16 stages, then trims and renormalises
    stream = list(tprog.separate_progressive_stream(
        model, [mixes.shape[1]] * N, lambda i: (mixes[i],), depth1=D1,
        threshold=-1.0, batch_size=BATCH, compute_dtype=torch.bfloat16))
    for i, _, est in stream:
        np.testing.assert_array_equal(est, tsep.trim_renorm(mixes[i],
                                                            got[i]))
