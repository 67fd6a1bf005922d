"""The port's deployment engines on the CPU (``tdanet_tpu_torch/deploy.py``):
the early-exit programs, the progressive stage pair through
``progressive.progressive_loop``, the streaming program through
``MultiStreamSeparator``, a bf16 bundle, a bundle served in a fresh
interpreter that never imports ``tdanet_tpu_torch.models``, and the two
CLIs (``python -m tdanet_tpu_torch.export_bundle`` and ``audio_test
--bundle``) against the model-code eval. Each engine is held against the
port's own path on the same model (``tests/test_torch_deploy.py`` holds the
bundles against the JAX package's). The models: width 32/64, pyramid
depth 4, 8 kHz, 1 block and 3 blocks, seeded numpy-perturbed weights.
"""
import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import perturb_flat

from tdanet_tpu_torch import deploy as tdeploy
from tdanet_tpu_torch.models import TDANetBest, load_jax_params
from tdanet_tpu_torch.progressive import separate_progressive
from tdanet_tpu_torch.utils import separate_batched, trim_renorm

SR = 8000
CFG = dict(out_channels=32, in_channels=64, num_blocks=1,
           upsampling_depth=4, enc_kernel_size=4, num_sources=2,
           sample_rate=SR)
DEEP = {**CFG, "num_blocks": 3}
# the deep bundle's one bucket (4096) holds all three
DEEP_LENGTHS = (0.5, 0.49, 0.485)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(cfg, seed):
    """A TDANetBest of ``cfg`` whose every weight is seeded numpy noise
    around its default init."""
    model = TDANetBest(**cfg).eval()
    flat = {k: v.numpy() for k, v in model.state_dict().items()}
    return load_jax_params(model, perturb_flat(flat, seed))


def _wavs(seconds, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(SR * s)) * 0.1).astype(np.float32)
            for s in seconds]


@pytest.fixture(scope="module")
def model():
    return _model(CFG, seed=43)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """A 3-block model and its bundle: DEEP_LENGTHS' bucket, batch 2, the
    early-exit depth 1 and the progressive pair at depth 2."""
    model = _model(DEEP, seed=42)
    path = tmp_path_factory.mktemp("deep")
    meta = tdeploy.save_bundle(str(path), model, lengths=DEEP_LENGTHS[:1],
                               batch_size=2, devices=("cpu",),
                               early_exit=[1],
                               progressive=dict(depth1=2, threshold=0.05))
    return model, path, meta


def test_streaming_from_a_bundle(model, tmp_path):
    """A streaming bundle (0.5 s segments, 2 streams) serves live streams
    through ``MultiStreamSeparator``'s stitching with the program as its
    forward: the model's engine's output; the batched loader points a
    streaming-only bundle at ``load_streaming``."""
    from tdanet_tpu_torch.serving import MultiStreamSeparator
    meta = tdeploy.save_bundle(
        str(tmp_path), model, devices=("cpu",),
        streaming=dict(segment=0.5, max_streams=2, overlap=0.25))
    assert meta["streaming"]["seg_len"] == SR // 2
    assert meta["streaming"]["n_src"] == 2
    with pytest.raises(ValueError, match="streaming-only"):
        tdeploy.load_bundle(str(tmp_path), device="cpu")
    engines = {"bundle": tdeploy.load_streaming(str(tmp_path), device="cpu"),
               "model": MultiStreamSeparator(model, max_streams=2,
                                             segment=0.5, overlap=0.25,
                                             sample_rate=SR)}
    assert tdeploy.op_nodes(engines["bundle"].module) == 25
    wavs = dict(zip("ab", _wavs((1.3, 1.1), seed=6)))
    outs = {}
    for name, eng in engines.items():
        parts = {sid: [] for sid in wavs}
        for sid, w in wavs.items():
            eng.open(sid)
            eng.push(sid, w)
        while True:
            got = eng.step()
            if not got:
                break
            for sid, est in got.items():
                parts[sid].append(est)
        for sid in wavs:
            parts[sid].append(eng.flush(sid))
        outs[name] = {sid: np.concatenate(parts[sid], axis=1)
                      for sid in wavs}
    for sid, w in wavs.items():
        assert outs["bundle"][sid].shape == (2, w.shape[-1])
        np.testing.assert_allclose(outs["bundle"][sid], outs["model"][sid],
                                   rtol=1e-5, atol=1e-6)


def test_early_exit_programs(deep, tmp_path):
    """early_exit=[1]: one more program a bucket; load_bundle(num_blocks=1)
    serves it as ``separate_batched(num_blocks=1)``; the full depth stays
    the default; the guards of the JAX package."""
    model, path, meta = deep
    assert meta["early_exit"] == [1]
    assert (path / "programs" / "E1_T4096_B2.cpu.pt2").exists()
    wavs = _wavs(DEEP_LENGTHS, seed=7)
    full = tdeploy.load_bundle(str(path), device="cpu")
    want_full = separate_batched(model, wavs, batch_size=2)
    for g, w in zip(full.separate_batched(wavs), want_full):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    dep1 = tdeploy.load_bundle(str(path), device="cpu", num_blocks=1)
    assert tdeploy.op_nodes(dep1.modules[4096]) == 25
    assert tdeploy.op_nodes(full.modules[4096]) == 75
    want1 = separate_batched(model, wavs, batch_size=2, num_blocks=1)
    for g, w, f in zip(dep1.separate_batched(wavs), want1, want_full):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert np.abs(g - f).max() > 1e-4
    with pytest.raises(ValueError, match="early-exit depths"):
        tdeploy.load_bundle(str(path), device="cpu", num_blocks=2)
    for kw, what in ((dict(lengths=[0.5], early_exit=[3]),
                      "early_exit depth"),
                     (dict(lengths=[], early_exit=[1]), "needs lengths"),
                     (dict(lengths=[0.5], progressive=dict(
                         depth1=2, depth_full=5)),
                      "exceeds the trained depth"),
                     (dict(lengths=[], progressive=dict(depth1=2)),
                      "needs lengths")):
        with pytest.raises(ValueError, match=what):
            tdeploy.save_bundle(str(tmp_path / "bad"), model, batch_size=2,
                                devices=("cpu",), **kw)
    assert not (tmp_path / "bad").exists()  # refused before any export
    copy = tmp_path / "copy"
    shutil.copytree(path, copy)
    os.remove(copy / "programs" / "E1_T4096_B2.cpu.pt2")
    with pytest.raises(ValueError, match="no early-exit programs"):
        tdeploy.load_bundle(str(copy), device="cpu", num_blocks=1)


def test_progressive_matches_separate_progressive(deep):
    """The stage pair through ``progressive_loop``: at thresholds -1
    (every utterance escalated), inf (none) and the median stage-1 delta
    (a gather of some rows across a full and a ragged stage-1 batch),
    each utterance as ``separate_progressive`` gives it, with its census;
    on the card each stage is one CUDA graph a bucket."""
    model, path, meta = deep
    assert meta["progressive"] == {"depth1": 2, "depth_full": 3,
                                   "threshold": 0.05}
    dep = tdeploy.load_progressive(str(path), device="cpu")
    assert dep.n_src == 2
    m1, m2 = dep.stages[4096]
    assert (tdeploy.op_nodes(m1), tdeploy.op_nodes(m2)) == (50, 25)
    wavs = _wavs(DEEP_LENGTHS, seed=8)
    mixes = np.zeros((len(wavs), 4096), np.float32)
    for row, w in enumerate(wavs):
        mixes[row, :w.shape[-1]] = w
    deltas = separate_progressive(model, mixes, depth1=2, threshold=np.inf,
                                  batch_size=2)[1]["delta"]
    for thr in (-1.0, np.inf, float(np.median(deltas))):
        stats = {}
        got = dep.separate_batched(wavs, threshold=thr, stats=stats)
        ests, info = separate_progressive(model, mixes, depth1=2,
                                          threshold=thr, batch_size=2)
        assert stats == {"n": 3, "n_escalated": info["n_escalated"]}
        for g, w, e in zip(got, wavs, ests):
            np.testing.assert_allclose(g, trim_renorm(w, e), rtol=1e-5,
                                       atol=1e-6)
    assert stats["n_escalated"] == 1


def test_bf16_bundle(model, tmp_path):
    """compute_dtype="bfloat16": the casts are traced, #1's sites run in
    bf16; the bundle gives ``separate_batched(compute_dtype=bf16)``."""
    meta = tdeploy.save_bundle(str(tmp_path), model, lengths=[0.5],
                               batch_size=2, devices=("cpu",),
                               compute_dtype="bfloat16")
    assert meta["compute_dtype"] == "bfloat16"
    wavs = _wavs((0.5, 0.49), seed=9)
    got = tdeploy.load_bundle(str(tmp_path), device="cpu") \
        .separate_batched(wavs)
    want = separate_batched(model, wavs, batch_size=2,
                            compute_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)



def _write_split(root, lengths, seed):
    from tdanet_tpu_torch.utils import write_wav
    rng = np.random.default_rng(seed)
    infos = {"mix_clean": [], "s1": [], "s2": []}
    for i, T in enumerate(lengths):
        t = np.arange(T) / SR
        srcs = [0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * t)
                + 0.02 * rng.standard_normal(T) for _ in range(2)]
        for key, data in (("mix_clean", srcs[0] + srcs[1]),
                          ("s1", srcs[0]), ("s2", srcs[1])):
            path = os.path.join(root, key, f"utt{i}.wav")
            write_wav(path, data, SR)
            infos[key].append([path, T])
    for key, rows in infos.items():
        with open(os.path.join(root, f"{key}.json"), "w") as f:
            json.dump(rows, f)


@pytest.fixture(scope="module")
def cli_run(model, tmp_path_factory):
    """The 1-block model's best_model.pth, its frozen conf.yml, a corpus of
    five utterances in two lattice buckets (3840 and 4096 samples) and the
    bundle the export CLI makes of it with ``--lengths_from_manifest``."""
    from tdanet_tpu_torch import export_bundle
    from tdanet_tpu_torch.utils.parser import save_yaml
    root = tmp_path_factory.mktemp("cli")
    tt = root / "tt"
    _write_split(str(tt), [4000, 4090, 3800, 4050, 3830], seed=7)
    exp = root / "exp"
    os.makedirs(exp)
    torch.save(model.serialize(), exp / "best_model.pth")
    conf = {
        "audionet": {"audionet_name": "TDANetBest", "audionet_config": {
            k: v for k, v in CFG.items() if k != "sample_rate"}},
        "datamodule": {"data_name": "Libri2MixDataModule", "data_config": {
            "train_dir": str(tt), "valid_dir": str(tt), "test_dir": str(tt),
            "n_src": 2, "sample_rate": SR, "segment": 0.4,
            "normalize_audio": False, "batch_size": 2, "num_workers": 0}},
        "exp": {"exp_name": "bundle_eval"},
        "main_args": {"exp_dir": str(exp)}}
    save_yaml(str(exp / "conf.yml"), conf)
    bundle = root / "bundle"
    meta = export_bundle.main([
        "--ckpt", str(exp / "best_model.pth"), "--out", str(bundle),
        "--lengths_from_manifest", str(tt / "mix_clean.json"),
        "--batch", "2", "--devices", "cpu"])
    return root, str(exp / "conf.yml"), exp, bundle, meta


def _csv(path):
    with open(path) as f:
        return {r["snt_id"]: r for r in csv.DictReader(f)}


def test_audio_test_through_a_bundle(cli_run, monkeypatch):
    """The export CLI covers the corpus's two buckets; ``audio_test
    --bundle`` gives the model-code eval's metrics (within 1e-3 dB); the
    rules of the JAX CLI: --bundle excludes --num_blocks,
    --progressive_depth and --dp above 1, and a bundle of another sample
    rate is refused."""
    from tdanet_tpu_torch import audio_test
    root, conf, exp, bundle, meta = cli_run
    monkeypatch.chdir(root)
    assert meta["targets"] == [3840, 4096] and meta["devices"] == ["cpu"]
    rows = {}
    for tag, extra in (("model", ["--batch_size", "2"]),
                       ("bundle", ["--bundle", str(bundle)])):
        final = audio_test.main(["--conf_dir", conf, "--device", "cpu",
                                 *extra])
        assert audio_test.ok(final)
        rows[tag] = _csv(exp / "results" / "metrics.csv")
    assert sorted(rows["model"]) == sorted(rows["bundle"])
    assert len(rows["model"]) == 7  # five utterances, avg and std
    for k, want in rows["model"].items():
        for c in ("sdr", "sdr_i", "si-snr", "si-snr_i"):
            assert abs(float(rows["bundle"][k][c]) - float(want[c])) \
                <= 1e-3, (k, c)
    for extra in (["--num_blocks", "1"], ["--progressive_depth", "2"],
                  ["--dp", "2"]):
        with pytest.raises(SystemExit) as e:
            audio_test.main(["--conf_dir", conf, "--device", "cpu",
                             "--bundle", str(bundle), *extra])
        assert e.value.code == 2
    other = root / "bundle_16k"
    shutil.copytree(bundle, other)
    with open(other / "meta.json") as f:
        meta16 = {**json.load(f), "sample_rate": 16000}
    with open(other / "meta.json", "w") as f:
        json.dump(meta16, f)
    with pytest.raises(SystemExit, match="exported at 16000 Hz"):
        audio_test.main(["--conf_dir", conf, "--device", "cpu",
                         "--bundle", str(other)])


def test_a_fresh_interpreter_serves_without_model_code(cli_run, model):
    """A new interpreter loads the bundle and separates an utterance as
    ``separate_batched`` does here, and never imports
    ``tdanet_tpu_torch.models`` (nor JAX): the deployment claim, checked
    literally."""
    root, _, _, bundle, _ = cli_run
    wav = _wavs((0.5,), seed=11)[0]
    np.save(root / "wav.npy", wav)
    np.save(root / "want.npy", separate_batched(model, [wav])[0])
    code = f"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from tdanet_tpu_torch import deploy
dep = deploy.load_bundle({str(bundle)!r}, device="cpu")
out = dep.separate(np.load({str(root / 'wav.npy')!r}))
assert "tdanet_tpu_torch.models" not in sys.modules, "model code imported"
assert "jax" not in sys.modules, "jax imported"
np.testing.assert_allclose(out, np.load({str(root / 'want.npy')!r}),
                           rtol=1e-5, atol=1e-6)
print("OK")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, *filter(None, [env.get("PYTHONPATH")])])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
