"""The port's manifest preprocessing (``datas/preprocess.py``) against
the JAX package's: the manifests of a LibriMix and a WSJ0 tree
byte-equal, through ``preprocess_dataset`` and through the CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tdanet_tpu.datas import preprocess as jpre
from tdanet_tpu_torch.datas import preprocess as tpre
from tdanet_tpu_torch.utils.audio_io import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tree per layout: {split: [channel, ...]}, a split of the layout left
# out, a channel of it left out, a non-wav file beside the wavs
TREES = {
    "librimix": {"train-100": ["mix_clean", "s1", "s2", "noise"],
                 "dev": ["mix_clean", "mix_both", "s1", "s2"]},
    "wsj0": {"tr": ["mix", "s1", "s2"], "tt": ["mix", "s1", "s2"]},
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tree(root, dataset, seed=0):
    """Wavs of several lengths, PCM16 and float32, in file-name orders that
    differ from their writing order."""
    rng = np.random.default_rng(seed)
    for split, channels in TREES[dataset].items():
        for ch in channels:
            d = os.path.join(root, split, ch)
            for i in (3, 0, 11, 2):
                T = int(rng.integers(800, 4000))
                write_wav(os.path.join(d, f"utt{i}.wav"),
                          0.1 * rng.standard_normal(T), 8000,
                          subtype="pcm16" if i % 2 else "float32")
            with open(os.path.join(d, "notes.txt"), "w") as f:
                f.write("not a wav")
    return root


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("route", ["function", "cli"])
@pytest.mark.parametrize("dataset", sorted(TREES))
def test_manifests_are_byte_equal_to_the_jax_packages(tmp_path, dataset,
                                                      route):
    corpus = make_tree(str(tmp_path / "corpus"), dataset)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if route == "function":
        jpre.preprocess_dataset(corpus, want, dataset)
        tpre.preprocess_dataset(corpus, got, dataset)
    else:
        argv = ["--in_dir", corpus, "--out_dir", want, "--dataset", dataset]
        jpre.main(argv)
        argv[3] = got
        subprocess.run([sys.executable, "-m",
                        "tdanet_tpu_torch.datas.preprocess", *argv],
                       cwd=REPO, check=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    want, got = tree_bytes(want), tree_bytes(got)
    assert got == want
    channels = sum(len(c) for c in TREES[dataset].values())
    assert len(got) == channels
    # the rows: every wav, in name order, with its frame count
    split, chans = next(iter(TREES[dataset].items()))
    rows = tpre.preprocess_one_dir(os.path.join(corpus, split, chans[0]),
                                   str(tmp_path / "one"), "x")
    assert [os.path.basename(p) for p, _ in rows] == [
        "utt0.wav", "utt11.wav", "utt2.wav", "utt3.wav"]
    assert all(800 <= n < 4000 for _, n in rows)
