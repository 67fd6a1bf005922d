"""The port's inference path against the JAX package's: a .pth that JAX
exported loads through the port's from_pretrain; ``separate`` matches JAX's
in fp32; ``separate_batched`` keeps utterances independent; the CLI writes
one wav per source; WAV I/O agrees with JAX's."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_tdanet_best
from tdanet_tpu_torch.models import BaseModel, TDANetBest
from tdanet_tpu_torch.utils import (read_wav, separate, separate_batched,
                                    write_wav)

jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(out_channels=64, in_channels=128, num_blocks=2,
           upsampling_depth=5, enc_kernel_size=4, num_sources=2,
           sample_rate=16000)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: parallel test workers would otherwise
    oversubscribe the cores (each op's parallel region waiting for threads
    the other workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, JAX params, path of the .pth JAX exported)."""
    from tdanet_tpu.models import flat_torch_to_pytree
    from tdanet_tpu.system.checkpoint import export_torch_pth
    jmodel, flat = jax_tdanet_best(CFG, seed=11)
    params = flat_torch_to_pytree(flat)
    path = str(tmp_path_factory.mktemp("ckpt") / "best_model.pth")
    export_torch_pth(jmodel, params, path)
    return jmodel, params, path


def _wav(T, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(
        2 * np.pi * 347 * t + 1.0) + 0.05 * rng.standard_normal(T)) \
        .astype(np.float32)


def test_from_pretrain_reads_jax_export(exported):
    from tdanet_tpu.models import pytree_to_flat_torch
    _, params, path = exported
    model = BaseModel.from_pretrain(path)
    assert isinstance(model, TDANetBest) and not model.training
    assert model.get_model_args() == {**CFG}
    want = pytree_to_flat_torch(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_from_pretrain_strips_lightning_prefix(exported, tmp_path):
    _, _, path = exported
    conf = torch.load(path, weights_only=True)
    conf["state_dict"] = {f"audio_model.{k}": v
                          for k, v in conf["state_dict"].items()}
    prefixed = str(tmp_path / "prefixed.pth")
    torch.save(conf, prefixed)
    a = BaseModel.from_pretrain("TDANetBest", prefixed).state_dict()
    b = BaseModel.from_pretrain(path).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", ["jax_serialize", "torch_version_infos"])
def test_from_pretrain_reads_what_the_jax_package_reads(exported, tmp_path,
                                                        kind):
    """Two more checkpoints the JAX package's reader takes: its own
    ``torch.save(model.serialize(params))`` (numpy arrays in the state
    dict) and a reference-schema file whose ``infos`` holds a
    ``TorchVersion``. Both give export_torch_pth's state dict."""
    from tdanet_tpu.models import load_torch_checkpoint as jax_load
    jmodel, params, path = exported
    other = str(tmp_path / f"{kind}.pth")
    if kind == "jax_serialize":
        conf = jmodel.serialize(params)
        assert all(isinstance(v, np.ndarray)
                   for v in conf["state_dict"].values())
    else:
        conf = torch.load(path, weights_only=True)
        conf["infos"] = {"software_versions": {
            "torch_version": torch.__version__}}
        assert isinstance(conf["infos"]["software_versions"][
            "torch_version"], torch.torch_version.TorchVersion)
    torch.save(conf, other)
    jax_load(other)  # the JAX package's reader takes it
    want = BaseModel.from_pretrain(path).state_dict()
    got = BaseModel.from_pretrain(other).state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_load_admits_no_other_class(tmp_path):
    """The weights-only load still refuses what it was not told of."""
    import fractions
    from tdanet_tpu_torch.models.base import load_torch_checkpoint
    path = str(tmp_path / "odd.pth")
    torch.save({"state_dict": {}, "infos": fractions.Fraction(1, 3)}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        load_torch_checkpoint(path)


def test_from_pretrain_missing_path_raises_without_network():
    with pytest.raises(FileNotFoundError, match="local checkpoint"):
        BaseModel.from_pretrain("org/some-hub-model")


def test_separate_matches_jax_fp32(exported):
    from tdanet_tpu.utils.separator import separate as jax_separate
    jmodel, params, path = exported
    wav = _wav(9000, 1)  # off the 1024-sample lattice
    want = np.asarray(jax_separate(jmodel, params, wav))
    got = separate(BaseModel.from_pretrain(path), wav)
    assert got.shape == want.shape == (2, 9000) and got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * scale)
    # per-utterance renormalisation over the true region
    np.testing.assert_allclose(np.abs(got).sum(), np.abs(wav).sum(),
                               rtol=1e-4)


def test_separate_batched_keeps_utterances_independent(exported):
    model = BaseModel.from_pretrain(exported[2])
    # two share a lattice bucket (5120), one does not (3072)
    wavs = [_wav(5000, 2), _wav(3000, 3), _wav(5100, 4)]
    got = separate_batched(model, wavs, batch_size=8)
    for w, g in zip(wavs, got):
        want = separate(model, w)
        assert g.shape == want.shape == (2, w.shape[-1])
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


def test_separate_batched_keeps_float64():
    """A float64 model's separate_batched answers in float64, equal to
    separate's (the JAX separate_batched keeps the model's dtype). A
    small model: float64 convolutions are slow on the CPU."""
    model = TDANetBest(out_channels=8, in_channels=16, num_blocks=1,
                       upsampling_depth=2, enc_kernel_size=4)
    model = model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.double().eval()
    wavs = [_wav(1000, 7), _wav(990, 8), _wav(500, 9)]  # two share a bucket
    got = separate_batched(model, wavs, batch_size=8)
    for w, g in zip(wavs, got):
        want = separate(model, w)
        assert g.dtype == want.dtype == np.float64
        np.testing.assert_allclose(g, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_inference_cli_writes_one_wav_per_source(exported, tmp_path):
    wav = _wav(7777, 5)
    mix = str(tmp_path / "mix.wav")
    write_wav(mix, wav, 16000)
    out = str(tmp_path / "sep")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "tdanet_tpu_torch.inference", exported[2],
         mix, out, "--device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for i in (1, 2):
        data, sr = read_wav(f"{out}_s{i}.wav")
        assert sr == 16000 and data.shape == (7777,)
        assert np.isfinite(data).all() and np.abs(data).max() > 0


@pytest.mark.parametrize("subtype", ["float32", "pcm16"])
def test_wav_io_matches_jax(tmp_path, subtype):
    from tdanet_tpu.utils import audio_io as jio
    data = np.clip(_wav(1234, 6), -1, 1)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, data, 8000, subtype=subtype)
    jio.write_wav(b, data, 8000, subtype=subtype)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, sr = read_wav(a, start=3, stop=1000)
    want, jsr = jio.read_wav(a, start=3, stop=1000)
    assert sr == jsr == 8000
    np.testing.assert_array_equal(got, want)


def test_read_wav_unsigned_8_bit(tmp_path):
    """8-bit PCM is unsigned around 128 (the JAX copy raises KeyError on
    it: it looks the scale up after converting to float32)."""
    from scipy.io import wavfile
    path = str(tmp_path / "u8.wav")
    wavfile.write(path, 8000, np.array([0, 64, 128, 192, 255], np.uint8))
    got, sr = read_wav(path)
    assert sr == 8000 and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, (np.array([0, 64, 128, 192, 255]) - 128.0) / 128.0)
