"""Manifest-JSON separation datasets and a prefetching loader (counterpart
of ``tdanet_tpu/datas/datasets.py``).

Same manifest contract as the reference (DataPreProcess/process_*.py):
each split dir holds ``{mix_key}.json`` + ``s1.json``/``s2.json`` listing
``[wav_path, n_frames]`` pairs. The dataset drops utterances shorter than
the training segment, random-crops segments at train time, keeps the full
length at test (segment=None), and optionally normalises by the
mixture's std. The loader is a threaded prefetching iterator of
fixed-shape numpy batches whose crops are seeded per (seed, epoch,
batch), so two loaders with one seed give the same batches.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from tdanet_tpu_torch.utils.audio_io import read_wav

EPS = 1e-8


def normalize_wav(wav, std=None, eps=EPS):
    """(x - mean) / (std + eps) over the last axis
    (libri2mixdatamodule.py:21-25)."""
    mean = wav.mean(-1, keepdims=True)
    if std is None:
        std = wav.std(-1, keepdims=True)
    return (wav - mean) / (std + eps)


class SeparationDataset:
    """Generic n-src manifest dataset (the Libri2Mix/LRS2/WHAM/WSJ0 pattern;
    only the mix manifest name differs: mix_clean/mix/mix_both). Audio
    only: the JAX package's audio-visual items (mouth crops) are not
    ported."""

    def __init__(self, json_dir, mix_key="mix_clean", n_src=2,
                 sample_rate=8000, segment=4.0, normalize_audio=False,
                 source_keys=None, audio_only=True):
        if not json_dir:
            raise ValueError("JSON DIR is None!")
        if not audio_only:
            raise ValueError("audio-visual data (audio_only=False) is not "
                             "ported")
        self.json_dir = json_dir
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio
        self.n_src = n_src
        self.seg_len = None if segment is None else int(segment * sample_rate)
        self.test = self.seg_len is None
        # n_src=1 still reads BOTH s1/s2 manifests: the reference
        # hardcodes sources_json to ["s1", "s2"] for n_src in (1, 2)
        # (libri2mixdatamodule.py:57-60) and expands each utterance
        # into one (mix, source) pair per source below
        source_keys = source_keys or \
            [f"s{i + 1}" for i in range(2 if n_src == 1 else n_src)]

        with open(os.path.join(json_dir, f"{mix_key}.json")) as f:
            mix_infos = json.load(f)
        sources_infos = []
        for skey in source_keys:
            with open(os.path.join(json_dir, f"{skey}.json")) as f:
                sources_infos.append(json.load(f))

        self.drop_utt, self.drop_len = 0, 0
        if not self.test:
            keep = [i for i, info in enumerate(mix_infos)
                    if info[1] >= self.seg_len]
            self.drop_utt = len(mix_infos) - len(keep)
            self.drop_len = sum(info[1] for info in mix_infos
                                if info[1] < self.seg_len)
            mix_infos = [mix_infos[i] for i in keep]
            sources_infos = [[src[i] for i in keep] for src in sources_infos]
        if n_src == 1:
            # single-target mode: each utterance becomes one item per
            # source, target shape (1, T). Reference quirk (load-bearing
            # for epoch-order parity, libri2mixdatamodule.py:68-95): the
            # train-time expansion iterates the manifest BACKWARDS (the
            # drop loop doubles as the build loop), so utterance order
            # is reversed; the test branch iterates forwards.
            order = range(len(mix_infos) - 1, -1, -1) if not self.test \
                else range(len(mix_infos))
            mix_exp, src_exp = [], []
            for i in order:
                for src in sources_infos:
                    mix_exp.append(mix_infos[i])
                    src_exp.append(src[i])
            mix_infos, sources_infos = mix_exp, [src_exp]
        self.mix = mix_infos
        self.sources = sources_infos
        if self.drop_utt:
            print(
                f"Drop {self.drop_utt} utts"
                f"({self.drop_len / sample_rate / 3600:.2f} h) from "
                f"{self.drop_utt + len(mix_infos)} (shorter than "
                f"{self.seg_len} samples)")

    def __len__(self):
        return len(self.mix)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        path, n_frames = self.mix[idx][0], self.mix[idx][1]
        if self.test or n_frames == self.seg_len:
            start, stop = 0, None
        else:
            rng = rng or np.random.default_rng()
            start = int(rng.integers(0, n_frames - self.seg_len))
            stop = start + self.seg_len
        mixture, _ = read_wav(path, start, stop)
        srcs = [read_wav(src[idx][0], start, stop)[0]
                for src in self.sources]
        sources = np.stack(srcs, 0)
        if self.normalize_audio:
            m_std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, std=m_std)
            sources = normalize_wav(sources, std=m_std)
        return mixture, sources, os.path.basename(path)


class Loader:
    """Threaded, prefetching batch iterator with drop_last=True parity
    (libri2mixdatamodule.py:247-278). Yields (mix[B,T], src[B,n,T], names)."""

    def __init__(self, dataset: SeparationDataset, batch_size: int,
                 shuffle=False, num_workers=4, seed=0, drop_last=True,
                 prefetch=2):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(self.num_workers)

        def load_batch(batch_idx):
            idxs = order[batch_idx * self.batch_size:
                         (batch_idx + 1) * self.batch_size]
            item_rng = np.random.default_rng(
                (self.seed, self.epoch, batch_idx))
            items = [self.ds.__getitem__(int(i), item_rng) for i in idxs]
            mix = np.stack([it[0] for it in items])
            src = np.stack([it[1] for it in items])
            names = [it[2] for it in items]
            return mix, src, names

        def producer():
            # bounded in-flight futures: submitting the whole epoch up
            # front would let the pool race ahead of the consumer and
            # retain every completed batch in its Future (the queue
            # bound only throttles results already taken out of a
            # future) — unbounded host memory on a big corpus
            from collections import deque
            inflight: deque = deque()
            try:
                for b in range(n_batches):
                    inflight.append(pool.submit(load_batch, b))
                    if len(inflight) > self.num_workers + self.prefetch:
                        q.put(inflight.popleft().result())
                while inflight:
                    q.put(inflight.popleft().result())
                q.put(None)
            except Exception as e:
                # surface the error to the consumer (a missing/corrupt
                # wav must fail the epoch loudly, not silently truncate
                # it); also the normal path out on early consumer exit
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def pad_to_lattice(x: np.ndarray, lattice: int) -> Tuple[np.ndarray, int]:
    """Pad the last axis up to a multiple of ``lattice``; returns
    (padded, original_length). Keeps eval shapes on a few buckets."""
    T = x.shape[-1]
    target = ((T + lattice - 1) // lattice) * lattice
    if target == T:
        return x, T
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - T)]
    return np.pad(x, pad), T
