"""DataModules mirroring the reference's five modules (counterpart of
``tdanet_tpu/datas/modules.py``): Libri2Mix, WHAM, LRS2, WSJ0 read
manifest-JSON splits (differing only in the mix manifest name), LibriCSS
slices long-form wavs into overlapped windows for streaming separation.

The loaders are chosen as the JAX package chooses them: a split with a
fixed segment (train, validation and test alike) is read by the C++
thread-pool loader (:class:`~tdanet_tpu_torch.datas.native_loader.
NativeLoader`, the JAX ``NativeLoader``'s batches bit for bit), a
full-length split by the Python :class:`~tdanet_tpu_torch.datas.datasets.
Loader`. The two draw their order and crops from different generators, so
a fixed-segment split never falls back to the Python loader: a failed
build of the native one raises.
"""

from __future__ import annotations

import os

import numpy as np

from tdanet_tpu_torch.datas.datasets import (
    Loader,
    SeparationDataset,
    normalize_wav,
)
from tdanet_tpu_torch.datas.native_loader import NativeLoader
from tdanet_tpu_torch.utils.audio_io import read_wav, wav_frames


class _ManifestDataModule:
    """Shared train/val/test assembly (libri2mixdatamodule.py:181-286)."""

    MIX_KEY = "mix_clean"

    def __init__(self, train_dir, valid_dir, test_dir, n_src=2,
                 sample_rate=8000, segment=4.0, normalize_audio=False,
                 batch_size=64, num_workers=0, pin_memory=False,
                 persistent_workers=False, audio_only=True, **unused):
        if train_dir is None or valid_dir is None or test_dir is None:
            raise ValueError("JSON DIR is None!")
        self.train_dir, self.valid_dir, self.test_dir = (
            train_dir, valid_dir, test_dir)
        self.n_src = n_src
        self.sample_rate = sample_rate
        self.segment = segment
        self.normalize_audio = normalize_audio
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.audio_only = audio_only
        self.data_train = self.data_val = self.data_test = None

    def _make(self, json_dir, segment):
        return SeparationDataset(
            json_dir, mix_key=self.MIX_KEY, n_src=self.n_src,
            sample_rate=self.sample_rate, segment=segment,
            normalize_audio=self.normalize_audio,
            audio_only=self.audio_only, fps=getattr(self, "fps", 25))

    def setup(self):
        self.data_train = self._make(self.train_dir, self.segment)
        self.data_val = self._make(self.valid_dir, self.segment)
        # test split keeps the training segment like the reference (full
        # length only when segment=None)
        self.data_test = self._make(self.test_dir, self.segment)

    def _loader(self, ds, shuffle):
        """The C++ loader for a fixed segment, else the Python one
        (``tdanet_tpu/datas/modules.py:57-71``)."""
        if ds.seg_len is not None:
            return NativeLoader(ds, self.batch_size, shuffle=shuffle,
                                num_workers=self.num_workers or 2)
        return Loader(ds, self.batch_size, shuffle=shuffle,
                      num_workers=self.num_workers or 1)

    def train_dataloader(self):
        return self._loader(self.data_train, True)

    def val_dataloader(self):
        return self._loader(self.data_val, False)

    def test_dataloader(self):
        return self._loader(self.data_test, False)

    @property
    def make_loader(self):
        return (self.train_dataloader(), self.val_dataloader(),
                self.test_dataloader())

    @property
    def make_sets(self):
        return self.data_train, self.data_val, self.data_test


class Libri2MixDataModule(_ManifestDataModule):
    MIX_KEY = "mix_clean"   # libri2mixdatamodule.py:54


class WhamDataModule(_ManifestDataModule):
    MIX_KEY = "mix_both"    # whamdatamodule.py:56


class LRS2DataModule(_ManifestDataModule):
    MIX_KEY = "mix"         # lrs2datamodule.py:57

    def __init__(self, *args, fps=25, **kwargs):
        super().__init__(*args, **kwargs)
        self.fps = fps      # audio-visual mouth-crop framerate (lrs2:34,54)


class WSJ0DataModule(_ManifestDataModule):
    MIX_KEY = "mix"         # wsj02mixdatamodule.py:54


class LibriCSSDataset:
    """Long-form wavs sliced into seg_len windows with ``overlap`` ratio
    (libricssdatamodule.py:44-118): hop = seg_len*(1-overlap), zero-pad the
    tail and record pad_len. Item = [name, [segments], pad_len]."""

    def __init__(self, input_dir, n_src=2, sample_rate=8000, segment=4.0,
                 overlap=0.25, normalize_audio=False, audio_only=True):
        if not input_dir:
            raise ValueError("Input DIR is None!")
        self.sample_rate = sample_rate
        self.seg_len = int(segment * sample_rate)
        self.overlap = overlap
        self.normalize_audio = normalize_audio
        hop_len = int(self.seg_len * (1 - overlap))
        self.segments = []
        for audio_name in sorted(os.listdir(input_dir)):
            if not audio_name.endswith(".wav"):
                continue
            path = os.path.join(input_dir, audio_name)
            audio_len = wav_frames(path)
            wav, _ = read_wav(path)
            if wav.ndim > 1:
                wav = wav[:, 0]
            start_idx, pad_len = 0, 0
            segs = []
            while start_idx < audio_len:
                seg = wav[start_idx:start_idx + self.seg_len]
                if start_idx + self.seg_len > audio_len:
                    pad_len = start_idx + self.seg_len - audio_len
                    seg = np.concatenate(
                        [seg, np.zeros(pad_len, seg.dtype)])
                    start_idx += pad_len
                if self.normalize_audio:
                    seg = normalize_wav(seg, std=seg.std(-1, keepdims=True))
                segs.append(seg)
                start_idx += hop_len
            self.segments.append([audio_name, segs, pad_len])

    def __len__(self):
        return len(self.segments)

    def __getitem__(self, idx):
        return self.segments[idx]


class LibriCSSDataModule:
    """Long-form CSS datamodule (libricssdatamodule.py:160-262); train/val
    dirs are optional."""

    def __init__(self, train_dir="", valid_dir="", test_dir="", n_src=2,
                 sample_rate=8000, segment=4.0, overlap=0.25,
                 normalize_audio=False, batch_size=1, num_workers=0,
                 audio_only=True, **unused):
        self.dirs = dict(train=train_dir, valid=valid_dir, test=test_dir)
        self.kw = dict(n_src=n_src, sample_rate=sample_rate, segment=segment,
                       overlap=overlap, normalize_audio=normalize_audio,
                       audio_only=audio_only)
        self.data_train = self.data_val = self.data_test = None

    def setup(self):
        def make(d):
            return LibriCSSDataset(d, **self.kw) if d else None
        self.data_train = make(self.dirs["train"])
        self.data_val = make(self.dirs["valid"])
        self.data_test = make(self.dirs["test"])

    @property
    def make_sets(self):
        return self.data_train, self.data_val, self.data_test
