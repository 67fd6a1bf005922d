"""The port's two eval CLIs (``audio_test``, ``audio_test_css``) end to
end against the JAX CLIs on one JAX-written checkpoint, and their device,
``--dp`` and ``--bundle`` rules, on the CPU (split from
``test_torch_eval.py``, whose model and sizes they share: TDANetBest
width 32/64, 3 blocks, pyramid depth 3, 8 kHz)."""
import csv
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best

jax = pytest.importorskip("jax")

CFG = dict(out_channels=32, in_channels=64, num_blocks=3,
           upsampling_depth=3, enc_kernel_size=4, num_sources=2,
           sample_rate=8000)
SR = 8000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def cli_run(tmp_path_factory):
    """A JAX-written best_model.pth, its frozen conf.yml and a corpus of
    five utterances in two lattice buckets (4032 and 4096 samples)."""
    from tdanet_tpu.models import flat_torch_to_pytree
    from tdanet_tpu.system.checkpoint import export_torch_pth
    from tdanet_tpu_torch.utils.parser import save_yaml
    root = tmp_path_factory.mktemp("cli")
    tt = root / "tt"
    _write_split(str(tt), [4000, 4090, 3990, 4050, 4032], seed=7)
    exp = root / "Experiments" / "checkpoint" / "cli_eval"
    os.makedirs(exp)
    jmodel, flat = jax_tdanet_best(CFG, seed=22)
    export_torch_pth(jmodel, flat_torch_to_pytree(flat),
                     str(exp / "best_model.pth"))
    conf = {
        "audionet": {"audionet_name": "TDANetBest", "audionet_config": {
            k: v for k, v in CFG.items() if k != "sample_rate"}},
        "datamodule": {"data_name": "Libri2MixDataModule", "data_config": {
            "train_dir": str(tt), "valid_dir": str(tt), "test_dir": str(tt),
            "n_src": 2, "sample_rate": SR, "segment": 0.4,
            "normalize_audio": False, "batch_size": 2, "num_workers": 0}},
        "exp": {"exp_name": "cli_eval"}}
    save_yaml(str(exp / "conf.yml"), conf)
    return root, str(exp / "conf.yml"), exp


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _same_metrics(got, want):
    assert [r["snt_id"] for r in got] == [r["snt_id"] for r in want]
    assert got[-2]["snt_id"] == "avg" and got[-1]["snt_id"] == "std"
    for g, w in zip(got, want):
        for k in ("sdr", "sdr_i", "si-snr", "si-snr_i"):
            assert abs(float(g[k]) - float(w[k])) <= 1e-3, (k, g, w)


def _wav_lengths(root):
    from tdanet_tpu_torch.utils import read_wav
    out = {}
    for src in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, src))):
            out[src, name] = read_wav(os.path.join(root, src, name))[0].shape
    return out


@pytest.mark.parametrize("mode", [["--batch_size", "2"],
                                  ["--batch_size", "2",
                                   "--progressive_depth", "2",
                                   "--progressive_threshold", "0"]])
def test_audio_test_matches_the_jax_cli(cli_run, monkeypatch, capsys, mode):
    """The port's CLI and the JAX CLI on one JAX-written checkpoint, both in
    fp32 on the CPU: the same CSV row order (bucket order), every metric
    within 1e-3 dB, wavs of the same lengths; progressive prints the same
    census."""
    import audio_test as jcli
    from tdanet_tpu_torch import audio_test as tcli
    root, conf, exp = cli_run
    monkeypatch.chdir(root)
    results = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        out = str(root / f"sep_{name}")
        final = cli.main(["--conf_dir", conf, "--save_output", "true",
                          "--save_path", out, *mode, *extra])
        printed = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith("progressive:")]
        results[name] = (final, _csv(exp / "results" / "metrics.csv"),
                         _wav_lengths(out), printed)
    (jf, jcsv, jw, jp), (pf, pcsv, pw, pp) = results["jax"], results["port"]
    assert [r["snt_id"] for r in pcsv[:-2]] == [
        "utt0.wav", "utt2.wav", "utt4.wav", "utt1.wav", "utt3.wav"]
    _same_metrics(pcsv, jcsv)
    assert pw == jw and len(pw) == 10
    assert all(abs(pf[k] - jf[k]) <= 1e-3 for k in jf) and tcli.ok(pf)
    if "--progressive_depth" in mode:
        assert pp[0].split("(")[0] == jp[0].split("(")[0] == \
            "progressive: depth 2->3, escalated 5/5 "


def test_audio_test_css_matches_the_jax_cli(cli_run, monkeypatch,
                                            tmp_path):
    """Two long-form wavs (1.3 s, 1.9 s), 0.5 s segments, overlap 0.25,
    plain and progressive: the port's streams against the JAX CLI's (fp32,
    CPU) within 1e-4 of their peak, each of its input's length."""
    import audio_test_css as jcli
    from tdanet_tpu_torch import audio_test_css as tcli
    from tdanet_tpu_torch.utils import read_wav, write_wav
    root, conf, _ = cli_run
    monkeypatch.chdir(root)
    long = tmp_path / "long"
    rng = np.random.default_rng(8)
    lengths = {"a.wav": 10400, "b.wav": 15200}
    for name, T in lengths.items():
        write_wav(str(long / name), 0.1 * rng.standard_normal(T), SR)
    for extra in ([], ["--progressive_depth", "2"]):
        outs = {}
        for name, cli, dev in (("jax", jcli, []),
                               ("port", tcli, ["--device", "cpu"])):
            outs[name] = str(tmp_path / f"css_{name}_{len(extra)}")
            cli.main(["--conf_dir", conf, "--test_dir", str(long),
                      "--segment", "0.5", "--overlap", "0.25",
                      "--save_path", outs[name], *extra, *dev])
        for f, T in lengths.items():
            for s in ("s1", "s2"):
                got = read_wav(os.path.join(outs["port"], s, f))[0]
                want = read_wav(os.path.join(outs["jax"], s, f))[0]
                assert got.shape == want.shape == (T,)
                assert np.abs(got - want).max() <= 1e-4 * np.abs(
                    want).max()


def test_cli_device_rules_and_rejections(cli_run, monkeypatch):
    """--device defaults to cuda and, with no card, raises; --dp with a
    batch that is not a multiple of it, --dp above 1 with --bundle, and
    --mode sp, whose module is not ported, are rejected; so are --bundle
    and --progressive_depth with --num_blocks."""
    from tdanet_tpu_torch import audio_test, audio_test_css
    root, conf, _ = cli_run
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert audio_test.build_parser().parse_args(
        ["--conf_dir", conf]).device == "cuda"
    for cli, extra in ((audio_test, []),
                       (audio_test_css, ["--test_dir", str(root)])):
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["--conf_dir", conf, *extra])
    for argv in (["--dp", "2", "--batch_size", "3"],
                 ["--dp", "2", "--bundle", "b"],
                 ["--bundle", "b", "--num_blocks", "2"],
                 ["--progressive_depth", "2", "--num_blocks", "2"]):
        with pytest.raises(SystemExit) as e:
            audio_test.main(["--conf_dir", conf, "--device", "cpu", *argv])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        audio_test_css.main(["--conf_dir", conf, "--mode", "sp",
                             "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("dp", ["1", "0"])
def test_dp_of_one_is_the_one_device_path(cli_run, monkeypatch, dp):
    """--dp 1 (or less) runs the one-device path, as the JAX CLI does: the
    same metrics.csv as a run without it; --dp 2 over a batch of 3 rows,
    which two replicas cannot split, is refused by the parser."""
    from tdanet_tpu_torch import audio_test
    root, conf, exp = cli_run
    monkeypatch.chdir(root)
    assert audio_test.build_parser().parse_args(
        ["--conf_dir", conf, "--dp", dp]).dp == int(dp)
    runs = []
    for extra in ([], ["--dp", dp]):
        final = audio_test.main(["--conf_dir", conf, "--device", "cpu",
                                 "--batch_size", "2", *extra])
        runs.append((final, _csv(exp / "results" / "metrics.csv")))
    assert runs[0] == runs[1] and audio_test.ok(runs[1][0])
    with pytest.raises(SystemExit) as e:
        audio_test.main(["--conf_dir", conf, "--device", "cpu", "--dp", "2",
                         "--batch_size", "3"])
    assert e.value.code == 2


def test_experiment_dir_and_exit_code(cli_run, tmp_path, monkeypatch):
    """A conf whose trainer recorded main_args.exp_dir evaluates the run
    there (metrics.csv beside its best_model.pth); an empty corpus gives
    NaN and a failing exit code."""
    from tdanet_tpu_torch import audio_test
    from tdanet_tpu_torch.utils.parser import load_yaml, save_yaml
    root, conf, exp = cli_run
    monkeypatch.chdir(tmp_path)
    moved = tmp_path / "elsewhere"
    os.makedirs(moved)
    os.link(exp / "best_model.pth", moved / "best_model.pth")
    c = load_yaml(conf)
    c["main_args"] = {"exp_dir": str(moved)}
    save_yaml(str(moved / "conf.yml"), c)
    final = audio_test.main(["--conf_dir", str(moved / "conf.yml"),
                             "--device", "cpu", "--batch_size", "1"])
    assert audio_test.ok(final)
    assert len(_csv(moved / "results" / "metrics.csv")) == 5 + 2
    assert not os.path.exists(tmp_path / "Experiments")
    assert not audio_test.ok({"sdr_i": float("nan"), "si-snr_i": 1.0})
    assert not audio_test.ok({})
