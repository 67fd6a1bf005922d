"""The port's C++ batch loader (``datas/native_loader.py`` over
``native/loader.cc``) against the JAX package's ``NativeLoader`` and
against its own draws in plain Python, bit for bit: shuffle on and off,
epochs 0-2, 1 and 4 threads, PCM16 and float32 wavs, an utterance of
exactly the segment (crop start 0), an epoch started at
``start_epoch(2)``; the datamodules' train and validation loaders against
the JAX ones from one config; a failed build raises."""
import json
import os
import stat

import numpy as np
import pytest
import torch

from tdanet_tpu.datas import Libri2MixDataModule as JLibri2Mix
from tdanet_tpu.datas import SeparationDataset as JDataset
from tdanet_tpu.datas import native_loader as jnative
from tdanet_tpu_torch.datas import Libri2MixDataModule, SeparationDataset
from tdanet_tpu_torch.datas import native_loader as tnative
from tdanet_tpu_torch.utils.audio_io import write_wav

SR, SEGMENT = 8000, 0.25
SEG = int(SR * SEGMENT)
# samples of each utterance: the first exactly the segment (crop start 0,
# no draw), one a sample longer, the last shorter (both datasets drop it)
LENGTHS = [SEG, 2600, 3100, SEG + 1, 4000, 2500, 3500, 1500]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_split(root, subtype="float32", seed=0, lengths=LENGTHS):
    """Mixture and two sources per utterance, as wavs of ``subtype``, and
    their manifests."""
    rng = np.random.default_rng(seed)
    infos = {"mix_clean": [], "s1": [], "s2": []}
    for i, T in enumerate(lengths):
        s1, s2 = 0.2 * rng.standard_normal((2, T))
        for key, data in (("mix_clean", s1 + s2), ("s1", s1), ("s2", s2)):
            path = os.path.join(root, key, f"utt{i}.wav")
            write_wav(path, data, SR, subtype=subtype)
            infos[key].append([path, T])
    for key, rows in infos.items():
        with open(os.path.join(root, f"{key}.json"), "w") as f:
            json.dump(rows, f)
    return root


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("splits")
    return {subtype: make_split(str(root / subtype), subtype, seed=i)
            for i, subtype in enumerate(("pcm16", "float32"))}


def assert_same(got, want):
    assert len(got) == len(want) > 0
    for (gm, gs, gn), (wm, ws, wn) in zip(got, want):
        assert gm.dtype == wm.dtype == np.float32 and gn == wn
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)


def test_mt19937_64_is_the_standard_engine():
    """The 10000th output of a default-seeded std::mt19937_64 is
    9981545732273789042 (C++ [rand.predef]); seeds wrap modulo 2^64."""
    rng = tnative.MT19937_64(5489)
    for _ in range(9999):
        rng()
    assert rng() == 9981545732273789042
    a, b = tnative.MT19937_64(2 ** 64 + 7), tnative.MT19937_64(7)
    assert [a() for _ in range(400)] == [b() for _ in range(400)]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("subtype", ["pcm16", "float32"])
def test_batches_equal_the_jax_loader_and_the_plain_draws(splits, subtype,
                                                          shuffle, threads):
    """Epochs 0-2 of the port's loader, the JAX package's and the plain
    draws: the same mixtures, sources and names, bit for bit."""
    root = splits[subtype]
    jds = JDataset(root, sample_rate=SR, segment=SEGMENT)
    tds = SeparationDataset(root, sample_rate=SR, segment=SEGMENT)
    assert len(tds) == len(jds) == len(LENGTHS) - 1
    jl = jnative.NativeLoader(jds, 2, shuffle=shuffle, num_workers=threads,
                              seed=11)
    tl = tnative.NativeLoader(tds, 2, shuffle=shuffle, num_workers=threads,
                              seed=11)
    assert len(tl) == len(jl) == 3
    orders = []
    for epoch in range(3):
        got = list(tl)
        assert_same(got, list(jl))
        assert_same(got, list(tnative.plain_batches(tds, 2, shuffle, 11,
                                                    epoch)))
        orders.append(tnative.epoch_order(len(tds), shuffle, 11, epoch))
    # shuffled epochs differ from each other; unshuffled ones do not
    assert (orders[0] != orders[1]) == shuffle


def test_an_utterance_of_the_segment_is_read_from_its_start(splits):
    """Utterance 0 is exactly the segment: its crop starts at 0 with no
    draw, and the loader gives the whole file."""
    from tdanet_tpu_torch.utils.audio_io import read_wav
    root = splits["float32"]
    tds = SeparationDataset(root, sample_rate=SR, segment=SEGMENT)
    assert tds.mix[0][1] == SEG
    starts = tnative.crop_starts([SEG, SEG + 1, 4000], SEG, 3, 0, 0)
    assert starts[0] == 0 and starts[1] == 0  # a draw % 1
    mix, _, _ = next(iter(tnative.NativeLoader(tds, 1, shuffle=False)))
    np.testing.assert_array_equal(mix[0], read_wav(tds.mix[0][0])[0])


def test_an_epoch_set_before_iter_starts_there(splits):
    """A loader whose ``epoch`` is set to 2 before it is iterated (the C++
    ``start_epoch(2)``) gives the third epoch of a fresh loader, as the
    JAX loader does, and the plain draws of epoch 2."""
    root = splits["pcm16"]
    tds = SeparationDataset(root, sample_rate=SR, segment=SEGMENT)
    jds = JDataset(root, sample_rate=SR, segment=SEGMENT)
    fresh = tnative.NativeLoader(tds, 3, shuffle=True, seed=4)
    third = [list(fresh) for _ in range(3)][2]
    resumed = tnative.NativeLoader(tds, 3, shuffle=True, seed=4)
    jresumed = jnative.NativeLoader(jds, 3, shuffle=True, seed=4)
    resumed.epoch = jresumed.epoch = 2
    got = list(resumed)
    assert_same(got, third)
    assert_same(got, list(jresumed))
    assert_same(got, list(tnative.plain_batches(tds, 3, True, 4, 2)))
    assert resumed.epoch == 3


@pytest.mark.parametrize("n_src,normalize", [(2, False), (1, True)])
def test_datamodule_loaders_equal_the_jax_datamodules(tmp_path, n_src,
                                                      normalize):
    """One config through both packages' Libri2MixDataModule: train and
    validation are the native loaders in both, and give the same batches
    over two epochs (the JAX native path leaves normalize_audio
    unapplied, and so does the port's)."""
    tr = make_split(str(tmp_path / "tr"), "pcm16", seed=5)
    cv = make_split(str(tmp_path / "cv"), "float32", seed=6,
                    lengths=LENGTHS[:5])
    conf = dict(train_dir=tr, valid_dir=cv, test_dir=cv, n_src=n_src,
                sample_rate=SR, segment=SEGMENT, normalize_audio=normalize,
                batch_size=2, num_workers=3)
    jdm, tdm = JLibri2Mix(**conf), Libri2MixDataModule(**conf)
    jdm.setup()
    tdm.setup()
    for which in ("train_dataloader", "val_dataloader"):
        jl, tl = getattr(jdm, which)(), getattr(tdm, which)()
        assert isinstance(jl, jnative.NativeLoader)
        assert isinstance(tl, tnative.NativeLoader)
        for _ in range(2):
            assert_same(list(tl), list(jl))


def _failing_compiler(tmp_path):
    path = tmp_path / "broken-c++"
    path.write_text("#!/bin/sh\necho 'loader.cc:1: error: no compiler "
                    "here' >&2\nexit 3\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_a_failed_build_raises(tmp_path, compiler):
    """A missing compiler is named, a failing one's stderr is raised; no
    library is left behind."""
    cxx = str(tmp_path / "no-such-c++") if compiler == "missing" \
        else _failing_compiler(tmp_path)
    build_dir = tmp_path / "build"
    want = "not found" if compiler == "missing" else "no compiler here"
    with pytest.raises(RuntimeError, match=want):
        tnative.build_library(cxx=cxx, build_dir=build_dir)
    with pytest.raises(RuntimeError, match=want):
        tnative.load_library(cxx=cxx, build_dir=build_dir)
    assert not tnative.library_path(build_dir).exists()


def test_the_datamodule_raises_where_the_build_fails(tmp_path, monkeypatch):
    """A fixed-segment split never falls back to the Python Loader: with
    the build failing, the datamodule's loaders raise; a full-length split
    is the Python Loader's."""
    from tdanet_tpu_torch.datas import Loader
    real = tnative.build_library
    monkeypatch.setattr(tnative, "_LIBS", {})
    monkeypatch.setattr(tnative, "build_library",
                        lambda cxx="g++", build_dir=None: real(
                            str(tmp_path / "no-such-c++"),
                            tmp_path / "build"))
    root = make_split(str(tmp_path / "tr"), seed=7, lengths=LENGTHS[:4])
    conf = dict(train_dir=root, valid_dir=root, test_dir=root,
                sample_rate=SR, batch_size=2)
    dm = Libri2MixDataModule(segment=SEGMENT, **conf)
    dm.setup()
    for which in ("train_dataloader", "val_dataloader", "test_dataloader"):
        with pytest.raises(RuntimeError, match="not found"):
            getattr(dm, which)()
    full = Libri2MixDataModule(segment=None, **conf)
    full.setup()
    assert isinstance(full.test_dataloader(), Loader)
