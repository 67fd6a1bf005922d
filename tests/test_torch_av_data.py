"""The port's audio-visual items against the JAX package's: the dataset's
``audio_only=False`` items (mouth crops from each source's ``.npz``) and
the native loader's AV batches, on stored, deflated and uint8 archives,
bit for bit, and against the loader's plain draws; an archive that cannot
be read raises, naming the file."""
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

from tdanet_tpu.datas import LRS2DataModule as JLRS2
from tdanet_tpu.datas import SeparationDataset as JDataset
from tdanet_tpu.datas import native_loader as jnative
from tdanet_tpu_torch.datas import LRS2DataModule, SeparationDataset
from tdanet_tpu_torch.datas import native_loader as tnative
from tdanet_tpu_torch.probes import train_options

SR, FPS, HW = 8000, 25, (6, 5)
SEGMENT, N_UTT = train_options.AV_SEGMENT, train_options.AV_UTT
FPS_LEN = int(SEGMENT * FPS)
ARCHIVES = [(False, np.float32),    # np.savez: stored entries
            (True, np.float32),     # np.savez_compressed: deflate
            (False, np.uint8)]      # uint8 mouth crops


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_av_split(root, compressed=False, dtype=np.float32, seed=7,
                  mix_key="mix_clean"):
    """N_UTT utterances of 2.25 s (longer than the segment, so crops are
    drawn), each source with an .npz of FPS_LEN - 3 .. FPS_LEN + 3 frames
    of HW (some truncated, some short): phase 29's split at the JAX
    test's frame size."""
    return train_options.write_av_split(root, compressed, dtype, seed=seed,
                                        hw=HW, mix_key=mix_key)


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("av")
    return {case: make_av_split(str(root / f"{case[0]}_{case[1].__name__}"),
                                *case)
            for case in ARCHIVES}


def _datasets(root, **kw):
    kw = dict(segment=SEGMENT, sample_rate=SR, audio_only=False, fps=FPS,
              **kw)
    return SeparationDataset(root, **kw), JDataset(root, **kw)


@pytest.mark.parametrize("case", ARCHIVES, ids=lambda c: str(c))
def test_av_items_match_jax(splits, case):
    """Each item (a seeded crop) equals the JAX dataset's: the audio, the
    mouths from frame 0 truncated to fps_len and not padded, in the
    archive's dtype, and the name; a mouth_preprocess is applied per
    source."""
    ours, theirs = _datasets(splits[case])
    assert ours.fps_len == theirs.fps_len == FPS_LEN
    for i in range(len(ours)):
        got = ours.__getitem__(i, np.random.default_rng(i))
        want = theirs.__getitem__(i, np.random.default_rng(i))
        assert len(got) == len(want) == 4 and got[3] == want[3]
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert got[2].shape[:1] == (2,) and got[2].shape[1] <= FPS_LEN
    scale = (lambda a: a.astype(np.float32) / 255.0)
    ours, theirs = _datasets(splits[case], mouth_preprocess=scale)
    np.testing.assert_array_equal(ours.__getitem__(1, None)[2],
                                  theirs.__getitem__(1, None)[2])


@pytest.mark.parametrize("case", ARCHIVES, ids=lambda c: str(c))
def test_native_av_batches_match_jax(splits, case):
    """The native AV batches over two shuffled epochs equal the JAX
    NativeLoader's bit for bit, and the loader's plain draws; each batch's
    mouths are the items' frames as float32, zero past their end."""
    ours, theirs = _datasets(splits[case])
    kw = dict(batch_size=2, shuffle=True, num_workers=2, seed=3)
    loader = tnative.NativeLoader(ours, **kw)
    jloader = jnative.NativeLoader(theirs, **kw)
    assert (loader.mh, loader.mw, loader.fps_len) == (*HW, FPS_LEN)
    for epoch in range(2):
        got, want = list(loader), list(jloader)
        plain = list(tnative.plain_batches(ours, 2, True, 3, epoch))
        assert len(got) == len(want) == len(plain) == N_UTT // 2
        for g, w, p in zip(got, want, plain):
            assert g[2].shape == (2, 2, FPS_LEN, *HW)
            assert g[2].dtype == np.float32
            for a, b, c in zip(g[:3], w[:3], p[:3]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
    order = tnative.epoch_order(N_UTT, True, 3, 0)
    mix, src, mouth, _ = next(iter(tnative.NativeLoader(ours, **kw)))
    for k in range(2):
        item = ours.__getitem__(order[k], None)
        nf = item[2].shape[1]
        np.testing.assert_array_equal(mouth[k][:, :nf],
                                      item[2].astype(np.float32))
        assert not mouth[k][:, nf:].any()


def _broken_copy(src, dst, how):
    """``src`` archive written to ``dst``, cut short, with its compressed
    stream garbled, or with an uncompressed size of 2**60 bytes in its
    central directory (a zip64 extra field, the size field 0xFFFFFFFF)."""
    data = open(src, "rb").read()
    if how == "truncated":
        data = data[:len(data) // 2]
    elif how == "size":
        at = data.rindex(b"PK\x01\x02")
        nlen, elen = struct.unpack_from("<HH", data, at + 28)
        end = at + 46 + nlen + elen
        data = bytearray(data[:end] + struct.pack("<HHQ", 1, 8, 1 << 60)
                         + data[end:])
        struct.pack_into("<I", data, at + 24, 0xFFFFFFFF)
        struct.pack_into("<H", data, at + 30, elen + 12)
        eocd = data.rindex(b"PK\x05\x06")
        struct.pack_into("<I", data, eocd + 12,
                         struct.unpack_from("<I", data, eocd + 12)[0] + 12)
        data = bytes(data)
    else:  # garble the middle of the deflate stream
        mid = len(data) // 3
        data = data[:mid] + bytes(b ^ 0x5A for b in data[mid:mid + 64]) \
            + data[mid + 64:]
    with open(dst, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("how", ["truncated", "garbled"])
def test_an_archive_that_cannot_be_read_raises(tmp_path, how):
    """A bad archive in a later item fails its batch with the file's path
    (nothing yields zeros); a bad first archive fails the loader's set-up
    the same way."""
    root = make_av_split(str(tmp_path), compressed=True)
    with zipfile.ZipFile(os.path.join(root, "s1", "u0.npz")) as z:
        assert z.getinfo("data.npy").compress_type == zipfile.ZIP_DEFLATED
    bad = os.path.join(root, "s2", "u3.npz")
    _broken_copy(os.path.join(root, "s2", "u2.npz"), bad, how)
    ds = _datasets(root)[0]
    loader = tnative.NativeLoader(ds, batch_size=2, shuffle=False,
                                  num_workers=2, seed=0)
    with pytest.raises(RuntimeError, match=f"mouth archive '{bad}'"):
        list(loader)
    first = os.path.join(root, "s1", "u0.npz")
    _broken_copy(os.path.join(root, "s1", "u1.npz"), first, how)
    with pytest.raises(RuntimeError, match=f"mouth archive '{first}'"):
        tnative.NativeLoader(_datasets(root)[0], batch_size=2)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["stored", "deflated"])
def test_a_garbled_entry_size_raises(tmp_path, compressed):
    """An uncompressed size in the central directory that the entry cannot
    have is refused before anything is allocated from it: the loader
    raises with the file's path, at set-up and in a batch."""
    root = make_av_split(str(tmp_path), compressed=compressed)
    bad = os.path.join(root, "s1", "u2.npz")
    _broken_copy(os.path.join(root, "s1", "u1.npz"), bad, "size")
    with zipfile.ZipFile(bad) as z:
        assert z.getinfo("data.npy").file_size == 1 << 60
    loader = tnative.NativeLoader(_datasets(root)[0], batch_size=2,
                                  shuffle=False, num_workers=2, seed=0)
    with pytest.raises(RuntimeError, match=f"mouth archive '{bad}'"):
        list(loader)
    first = os.path.join(root, "s1", "u0.npz")
    _broken_copy(os.path.join(root, "s1", "u1.npz"), first, "size")
    with pytest.raises(RuntimeError, match=f"mouth archive '{first}'"):
        tnative.NativeLoader(_datasets(root)[0], batch_size=2)


def test_lrs2_module_passes_fps(tmp_path):
    """LRS2DataModule takes fps and hands it to its datasets, whose items
    equal the JAX module's."""
    root = make_av_split(str(tmp_path), mix_key="mix")
    kw = dict(train_dir=root, valid_dir=root, test_dir=root, segment=SEGMENT,
              sample_rate=SR, audio_only=False, fps=30, batch_size=2)
    ours, theirs = LRS2DataModule(**kw), JLRS2(**kw)
    ours.setup()
    theirs.setup()
    assert ours.data_train.fps_len == theirs.data_train.fps_len == 60
    got = ours.data_val.__getitem__(2, np.random.default_rng(0))
    want = theirs.data_val.__getitem__(2, np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
