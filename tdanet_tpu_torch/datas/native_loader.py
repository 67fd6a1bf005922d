"""ctypes bridge to the port's C++ batch loader (``native/loader.cc``),
counterpart of ``tdanet_tpu/datas/native_loader.py``, and the loader's
draws in plain Python.

:class:`NativeLoader` gives the JAX package's ``NativeLoader`` batches bit
for bit: a C++ thread pool decodes the cropped byte range of each wav,
assembles fixed-shape float32 batches and hands them over a bounded
queue; each batch comes out as ``(mix (B, T), sources (B, n_src, T),
names)`` with every name ``""`` and no normalisation (the JAX wrapper's
tuple: ``normalize_audio`` is not applied on this path there either).

Over an audio-visual dataset (``audio_only=False``) each batch is
``(mix, sources, mouths (B, n_src, fps_len, h, w) float32, names)``: the
loader reads every source's mouth crops from its ``.npz`` (stored or
deflated ``data.npy``, float32, float64 or uint8), truncated or
zero-padded on the frame axis. A batch with an archive that cannot be read
raises, naming the file.

The library is built with ``g++`` at first use into
``build/tdanet_tpu_torch/`` at the root of the checkout, its file named by
a hash of the source and the flags, and needs the C++ standard library and
zlib (``-lz``). A failed build raises with the compiler's stderr; nothing
falls back to the Python ``Loader``, whose batches differ.

The plain version (:func:`epoch_order`, :func:`crop_starts`,
:func:`plain_batches`) repeats the loader's draws in Python from the same
``std::mt19937_64`` streams (:class:`MT19937_64`) and reads through
``utils/audio_io``: the loader's reference where the JAX package is
absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tdanet_tpu_torch.utils.audio_io import read_wav

SOURCE = Path(__file__).resolve().parent.parent / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdanet_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]
#: after the source, so that the linker keeps them
LIBS = ["-lz"]
_MASK = (1 << 64) - 1
_LIBS: dict = {}


def library_path(build_dir=None) -> Path:
    """The library's path: named by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return Path(build_dir or BUILD_DIR) / \
        f"libtdanet_loader-{h.hexdigest()[:16]}.so"


def build_library(cxx="g++", build_dir=None) -> Path:
    """Compile ``native/loader.cc`` with ``cxx`` unless the library for
    this source exists under ``build_dir`` (default ``BUILD_DIR``). Raises
    RuntimeError naming a missing compiler, or with its stderr."""
    so = library_path(build_dir)
    if so.exists():
        return so
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"the native loader needs a C++ compiler: {cxx!r} not found")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [found, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load_library(cxx="g++", build_dir=None):
    """The loader's library (built if needed), its C functions typed."""
    so = build_library(cxx, build_dir)
    if so in _LIBS:
        return _LIBS[so]
    lib = ctypes.CDLL(str(so))
    lib.tdanet_loader_create.restype = ctypes.c_void_p
    lib.tdanet_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int]
    lib.tdanet_loader_next.restype = ctypes.c_int
    lib.tdanet_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.tdanet_loader_n_batches.restype = ctypes.c_int64
    lib.tdanet_loader_n_batches.argtypes = [ctypes.c_void_p]
    lib.tdanet_loader_start_epoch.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64]
    lib.tdanet_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.tdanet_loader_error.restype = ctypes.c_char_p
    lib.tdanet_loader_error.argtypes = [ctypes.c_void_p]
    lib.tdanet_loader_create_av.restype = ctypes.c_void_p
    lib.tdanet_loader_create_av.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.tdanet_loader_next_av.restype = ctypes.c_int
    lib.tdanet_loader_next_av.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.tdanet_npz_mouth_dims.restype = ctypes.c_int
    lib.tdanet_npz_mouth_dims.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int64)]
    _LIBS[so] = lib
    return lib


def native_available() -> bool:
    """Whether the library loads (built here if needed)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _paths(dataset, n_src, column=0):
    """The manifest's mixture paths, its sources' paths (``column`` 1: the
    mouth archives) item-major, and the lengths."""
    mix = [info[0].encode() for info in dataset.mix]
    src = [dataset.sources[s][i][column].encode()
           for i in range(len(dataset.mix)) for s in range(n_src)]
    return mix, src, np.asarray([info[1] for info in dataset.mix], np.int64)


def mouth_dims(path, lib=None):
    """The (frames, h, w) of an archive's ``data`` array, read by the
    library; raises naming the file if it cannot be read."""
    lib = lib or load_library()
    dims = (ctypes.c_int64 * 3)()
    if not lib.tdanet_npz_mouth_dims(os.fsencode(path), dims):
        raise RuntimeError(f"cannot read the mouth archive {path!r}")
    return tuple(int(d) for d in dims)


class NativeLoader:
    """C++-backed batch iterator over a SeparationDataset's manifest, with
    a fixed segment. Epoch e (the e-th ``iter``, or the one ``epoch`` is
    set to before it) draws its order and crops from ``seed`` and e.
    ``delivered`` counts the batches that all loaders have yielded."""

    delivered = 0

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=4,
                 seed=0, prefetch=4):
        self._lib = lib = load_library()
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle, self.seed = shuffle, seed
        self.seg = dataset.seg_len
        if self.seg is None:
            raise ValueError("NativeLoader requires a fixed segment length")
        self.n_src = dataset.n_src
        self.epoch = 0
        self.audio_only = getattr(dataset, "audio_only", True)
        mix, src, lengths = _paths(dataset, self.n_src)
        args = ((ctypes.c_char_p * len(mix))(*mix),
                (ctypes.c_char_p * len(src))(*src))
        common = (lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                  len(mix), self.n_src, self.seg, batch_size,
                  1 if shuffle else 0, seed, num_workers, prefetch)
        if self.audio_only:
            self._handle = lib.tdanet_loader_create(*args, *common)
            return
        mouths = _paths(dataset, self.n_src, column=1)[1]
        # every archive's frames are (h, w) of the first one's
        _, self.mh, self.mw = mouth_dims(mouths[0].decode(), lib)
        self.fps_len = int(dataset.fps_len)
        self._handle = lib.tdanet_loader_create_av(
            *args, (ctypes.c_char_p * len(mouths))(*mouths), *common,
            self.fps_len, self.mh, self.mw)

    def __len__(self):
        return int(self._lib.tdanet_loader_n_batches(self._handle))

    def __iter__(self):
        if self.epoch > 0:
            self._lib.tdanet_loader_start_epoch(self._handle, self.epoch)
        self.epoch += 1
        B, S, n = self.batch_size, self.seg, self.n_src
        fp = ctypes.POINTER(ctypes.c_float)
        while True:
            mix = np.empty((B, S), np.float32)
            src = np.empty((B, n, S), np.float32)
            if self.audio_only:
                rc = self._lib.tdanet_loader_next(
                    self._handle, mix.ctypes.data_as(fp),
                    src.ctypes.data_as(fp))
            else:
                mouth = np.empty((B, n, self.fps_len, self.mh, self.mw),
                                 np.float32)
                rc = self._lib.tdanet_loader_next_av(
                    self._handle, mix.ctypes.data_as(fp),
                    src.ctypes.data_as(fp), mouth.ctypes.data_as(fp))
            if rc < 0:
                path = self._lib.tdanet_loader_error(self._handle).decode()
                raise RuntimeError(f"cannot read the mouth archive {path!r}")
            if rc == 0:
                break
            NativeLoader.delivered += 1
            if self.audio_only:
                yield mix, src, [""] * B
            else:
                yield mix, src, mouth, [""] * B

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tdanet_loader_destroy(self._handle)
            self._handle = None


# -- the draws in plain Python ------------------------------------------------

class MT19937_64:
    """``std::mt19937_64``: seeded as the C++ constructor seeds it, each
    call the next 64-bit output."""

    N, M = 312, 156

    def __init__(self, seed):
        mt = [seed & _MASK]
        for i in range(1, self.N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i)
                      & _MASK)
        self.mt, self.i = mt, self.N

    def _twist(self):
        mt, N, M = self.mt, self.N, self.M
        for k in range(N):
            x = (mt[k] & 0xFFFFFFFF80000000) | (mt[(k + 1) % N] & 0x7FFFFFFF)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[k] = mt[(k + M) % N] ^ xa
        self.i = 0

    def __call__(self):
        if self.i >= self.N:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & _MASK


def epoch_order(n, shuffle, seed, epoch):
    """The items in epoch ``epoch``'s order: the loader's Fisher-Yates
    shuffle from ``mt19937_64(seed + epoch)``, or 0..n-1."""
    order = list(range(n))
    if shuffle:
        rng = MT19937_64(seed + epoch)
        for i in range(n, 1, -1):
            j = rng() % i
            order[i - 1], order[j] = order[j], order[i - 1]
    return order


def crop_starts(lengths, seg, seed, epoch, batch):
    """The crop starts of batch ``batch``'s items (their manifest
    ``lengths``), from ``mt19937_64(seed + epoch * 1000003 + batch)``: a
    draw modulo (length - seg) where the length exceeds ``seg``, else 0
    with no draw."""
    rng = MT19937_64(seed + epoch * 1000003 + batch)
    return [rng() % (n - seg) if n > seg else 0 for n in lengths]


def _segment(path, start, seg):
    """``seg`` frames from ``start``, zeros past the file's end."""
    data = read_wav(path, start, start + seg)[0]
    return np.pad(data, (0, seg - data.shape[0]))


def _mouth(path, fps_len):
    """An archive's ``data`` frames as float32, truncated or zero-padded
    to ``fps_len``."""
    with np.load(path) as archive:
        data = archive["data"][:fps_len].astype(np.float32)
    pad = [(0, fps_len - data.shape[0])] + [(0, 0)] * (data.ndim - 1)
    return np.pad(data, pad)


def plain_batches(dataset, batch_size, shuffle=False, seed=0, epoch=0):
    """Epoch ``epoch`` of :class:`NativeLoader` over ``dataset`` in plain
    Python: the same (mix, sources, names) batches, or (mix, sources,
    mouths, names) over an audio-visual dataset, from the same draws, read
    through ``utils/audio_io`` and ``numpy.load``."""
    seg, n_src = dataset.seg_len, dataset.n_src
    order = epoch_order(len(dataset.mix), shuffle, seed, epoch)
    for b in range(len(order) // batch_size):
        items = order[b * batch_size:(b + 1) * batch_size]
        starts = crop_starts([dataset.mix[i][1] for i in items], seg, seed,
                             epoch, b)
        mix = np.stack([_segment(dataset.mix[i][0], s, seg)
                        for i, s in zip(items, starts)])
        src = np.stack([[_segment(dataset.sources[k][i][0], s, seg)
                         for k in range(n_src)]
                        for i, s in zip(items, starts)])
        if getattr(dataset, "audio_only", True):
            yield mix, src, [""] * batch_size
            continue
        mouths = np.stack([[_mouth(dataset.sources[k][i][1],
                                   dataset.fps_len) for k in range(n_src)]
                           for i in items])
        yield mix, src, mouths, [""] * batch_size
