"""Data-parallel eval and serving on a local mesh of two CPU replicas
(``make_mesh(devices=["cpu", "cpu"])``) against the JAX package's paths on
a dp-2 mesh of the conftest's virtual CPU devices, in float64 on the same
weights (the eval tests' 1e-10): ``separate_batched``,
``separate_batched_stream`` with a ragged chunk, ``separate_progressive``
and its stream. Then ``audio_test --dp 2 --device cpu`` against
``--dp 1`` (the same metrics.csv), and ``BatchSeparationServer`` /
``AsyncBatchServer`` with a mesh against the same servers without one."""
import csv
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best, port_tdanet_best

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tdanet_tpu_torch import progressive as tprog  # noqa: E402
from tdanet_tpu_torch import serving as tserving  # noqa: E402
from tdanet_tpu_torch.parallel import make_mesh  # noqa: E402
from tdanet_tpu_torch.utils import separator as tsep  # noqa: E402

CFG = dict(out_channels=32, in_channels=64, num_blocks=3,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
SR = 8000
TOL = 1e-10
MESH = make_mesh(devices=["cpu", "cpu"])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Np64:
    """numpy with float32 read as float64: the JAX eval paths store their
    estimates in float32; here they keep float64 beside the port."""
    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, float64 JAX params, the port's float64 model)."""
    from tdanet_tpu.models import flat_torch_to_pytree
    jmodel, flat = jax_tdanet_best(CFG, seed=23)
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
    return jmodel, params, port_tdanet_best(CFG, flat, torch.float64)


@pytest.fixture
def x64(monkeypatch):
    """JAX in float64, its eval modules' host arrays too, and its dp-2
    mesh."""
    from tdanet_tpu import progressive as jprog
    from tdanet_tpu.parallel import make_mesh as jmake
    from tdanet_tpu.utils import separator as jsep
    monkeypatch.setattr(jsep, "np", _Np64())
    monkeypatch.setattr(jprog, "np", _Np64())
    with jax.enable_x64():
        yield jmake(dp=2, tp=1, devices=jax.devices()[:2])


def _items(lengths, seed):
    rng = np.random.default_rng(seed)
    return [((0.1 * rng.standard_normal(L)).astype(np.float32),
             (0.1 * rng.standard_normal((2, L))).astype(np.float32),
             f"utt{i}.wav") for i, L in enumerate(lengths)]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == np.float64
    scale = float(np.abs(want).max())
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_batched_stream_and_separate_batched_match_jax_on_a_mesh(pair, x64):
    """batch_size 4 over two replicas: the 640 bucket holds five
    utterances (a full chunk and a ragged one, padded to 4 rows, a padding
    row on one replica and the ragged row on the other); the same yield
    order as JAX's mesh stream, estimates within 1e-10; separate_batched
    returns them in input order."""
    from tdanet_tpu.utils.separator import separate_batched as jsb
    from tdanet_tpu.utils.separator import separate_batched_stream as jss
    jmodel, params, tmodel = pair
    lengths = [635, 640, 1277, 620, 630, 600, 1280]
    items = _items(lengths, 1)
    want = list(jss(jmodel, params, lengths, lambda i: items[i],
                    batch_size=4, compute_dtype=jnp.float64, mesh=x64))
    got = list(tsep.separate_batched_stream(
        tmodel, lengths, lambda i: items[i], batch_size=4, mesh=MESH))
    assert [i for i, _, _ in got] == [i for i, _, _ in want]
    for (i, item, est), (_, _, w) in zip(got, want):
        assert item is items[i] and est.shape == (2, lengths[i])
        _close(est, w)
    wavs = [it[0] for it in items]
    outs = tsep.separate_batched(tmodel, wavs, batch_size=4, mesh=MESH)
    # float64 wavs: JAX's separate_batched sums |wav| in the wav's dtype
    jouts = jsb(jmodel, params, [w.astype(np.float64) for w in wavs],
                batch_size=4, compute_dtype=jnp.float64, mesh=x64)
    for out, w in zip(outs, jouts):
        _close(out, w)
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        tsep.separate_batched(tmodel, wavs, batch_size=3, mesh=MESH)


def test_progressive_matches_jax_on_a_mesh(pair, x64):
    """Five mixtures of one length at batch_size 2 over two replicas, a
    threshold between the middle deltas: the escalated set, deltas and
    estimates of JAX's mesh run (stage-2 batches padded with the last
    escalated row)."""
    from tdanet_tpu.progressive import separate_progressive as jsp
    jmodel, params, tmodel = pair
    mixes = (0.1 * np.random.default_rng(4).standard_normal(
        (5, 1000))).astype(np.float32)
    _, info0 = tprog.separate_progressive(tmodel, mixes, depth1=2,
                                          threshold=np.inf, batch_size=2)
    thr = float(np.mean(np.sort(info0["delta"])[2:4]))
    want, winfo = jsp(jmodel, params, mixes, depth1=2, threshold=thr,
                      batch_size=2, compute_dtype=jnp.float64, mesh=x64)
    got, info = tprog.separate_progressive(tmodel, mixes, depth1=2,
                                           threshold=thr, batch_size=2,
                                           mesh=MESH)
    assert 0 < info["n_escalated"] < len(mixes)
    np.testing.assert_array_equal(info["escalated"], winfo["escalated"])
    _close(info["delta"], winfo["delta"])
    _close(got, want)


def test_progressive_stream_matches_jax_on_a_mesh(pair, x64):
    from tdanet_tpu.progressive import separate_progressive_stream as jps
    jmodel, params, tmodel = pair
    lengths = [640, 600, 1280, 633, 610, 1250]
    items = _items(lengths, 5)
    kw = dict(depth1=2, threshold=0.0, batch_size=2, group_size=4)
    wstats, gstats = {}, {}
    want = list(jps(jmodel, params, lengths, lambda i: items[i],
                    compute_dtype=jnp.float64, stats=wstats, mesh=x64,
                    **kw))
    got = list(tprog.separate_progressive_stream(
        tmodel, lengths, lambda i: items[i], stats=gstats, mesh=MESH, **kw))
    assert [i for i, _, _ in got] == [i for i, _, _ in want]
    for (_, _, est), (_, _, w) in zip(got, want):
        _close(est, w)
    assert gstats["n_escalated"] == wstats["n_escalated"] == len(lengths)
    assert abs(gstats["delta_sum"] - wstats["delta_sum"]) <= \
        TOL * abs(wstats["delta_sum"])


# -- the CLI and the servers -------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's float32 model written as best_model.pth, its conf.yml
    and a corpus of five utterances of 0.5 s."""
    from tdanet_tpu_torch.models import TDANetBest
    from tdanet_tpu_torch.probes.train_step import write_split
    from tdanet_tpu_torch.utils.parser import save_yaml
    root = tmp_path_factory.mktemp("dp_cli")
    tt = root / "tt"
    write_split(str(tt), 5, seed=7, seconds=0.5)
    exp = root / "exp"
    os.makedirs(exp)
    model = TDANetBest(**CFG).reset_parameters(
        torch.Generator().manual_seed(8))
    torch.save(model.serialize(), exp / "best_model.pth")
    conf = {
        "audionet": {"audionet_name": "TDANetBest", "audionet_config": {
            k: v for k, v in CFG.items() if k != "sample_rate"}},
        "datamodule": {"data_name": "Libri2MixDataModule", "data_config": {
            "train_dir": str(tt), "valid_dir": str(tt), "test_dir": str(tt),
            "n_src": 2, "sample_rate": SR, "segment": 0.4,
            "normalize_audio": False, "batch_size": 2, "num_workers": 0}},
        "exp": {"exp_name": "dp_eval"}, "main_args": {"exp_dir": str(exp)}}
    save_yaml(str(exp / "conf.yml"), conf)
    return root, str(exp / "conf.yml"), exp, model


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("mode", [[], ["--progressive_depth", "2",
                                       "--progressive_threshold", "0"]])
def test_audio_test_dp2_matches_dp1(cli_run, monkeypatch, mode):
    from tdanet_tpu_torch import audio_test
    root, conf, exp, _ = cli_run
    monkeypatch.chdir(root)
    runs = []
    for dp in ("1", "2"):
        final = audio_test.main(["--conf_dir", conf, "--device", "cpu",
                                 "--batch_size", "4", "--dp", dp, *mode])
        runs.append((final, _csv(exp / "results" / "metrics.csv")))
    (f1, c1), (f2, c2) = runs
    assert audio_test.ok(f2) and len(c2) == 7
    assert [r["snt_id"] for r in c1] == [r["snt_id"] for r in c2]
    for a, b in zip(c1, c2):
        for k in ("sdr", "sdr_i", "si-snr", "si-snr_i"):
            assert abs(float(a[k]) - float(b[k])) <= 1e-3, (k, a, b)


def test_batch_servers_with_a_mesh_match_without(cli_run):
    """BatchSeparationServer and AsyncBatchServer (adaptive ladder 2, 4
    over two replicas) answer in request order what the servers without a
    mesh answer; every replica runs its own program (two a shape)."""
    _, _, _, model = cli_run
    model = model.eval()
    rng = np.random.default_rng(9)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in (700, 650, 1300, 640, 1290)]
    plain = tserving.BatchSeparationServer(model, 4).separate(wavs)
    meshed = tserving.BatchSeparationServer(model, 4, mesh=MESH).separate(
        wavs)
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    with pytest.raises(ValueError, match="multiple of the mesh dp"):
        tserving.BatchSeparationServer(model, 3, mesh=MESH)
    with pytest.raises(ValueError, match="min_batch"):
        tserving.AsyncBatchServer(model, max_batch=4, adaptive=True,
                                  min_batch=1, mesh=MESH)
    servers = [tserving.AsyncBatchServer(model, max_batch=4, adaptive=True,
                                         min_batch=2, mesh=m)
               for m in (None, MESH)]
    try:
        answers = [[s.submit(w) for w in wavs] for s in servers]
        answers = [[f.result(timeout=120) for f in a] for a in answers]
    finally:
        for s in servers:
            s.close()
    for a, b in zip(answers[1], answers[0]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert servers[1].stats["rows"] == len(wavs)
    prog = next(iter(servers[1]._fwd_cache.values()))
    assert isinstance(prog, tserving.ReplicaPrograms)
    assert len(prog.parts) == 2 and prog.parts[0].rows * 2 == prog.rows
