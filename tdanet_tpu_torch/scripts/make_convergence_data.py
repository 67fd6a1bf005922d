"""Synthetic separable-by-construction corpus at the Libri2Mix recipe
shape (counterpart of ``scripts/make_convergence_data.py``; the same
seeds, draw order, wavs and manifests). Each mixture is n_src
disjoint-band harmonic voices with random f0, AM envelopes and phases;
it stands in for Libri2Mix train-100 (clean, 2 sources) and, with
``--n_src``/``--noise_snr``/``--var_len``, for the WHAM-style regime
(noisy ``mix_both`` mixture, clean targets; variable-length utterances
random-cropped at train time).

Every utterance draws from its own ``np.random.default_rng(seed0 + i)``
in this order: its length (drawn even when the length is fixed), the
voices in band order, then the noise. ``seed0`` is 0 for ``tr``,
``10**6`` for ``dev`` and ``2 * 10**6`` for ``tt``; dev and tt hold 100
utterances each. Writes ``<root>/<split>/<channel>/uttNNNN.wav``
(float32) and the manifests ``<root>/<split>/<channel>.json``
(``[[path, n_samples], ...]``).

Usage: python -m tdanet_tpu_torch.scripts.make_convergence_data <root>
         [n_train] [--n_src N] [--noise_snr DB] [--var_len LO,HI]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from tdanet_tpu_torch.utils.audio_io import write_wav

SR = 8000
# disjoint f0 bands; at most 3 harmonics each, capped at 0.9 Nyquist, so
# up to 4 voices stay spectrally separable by construction
BANDS = [(100, 280), (700, 1400), (320, 620), (1600, 2900)]
N_HELD_OUT = 100
SEEDS = {"tr": 0, "dev": 10**6, "tt": 2 * 10**6}


def voice(rng, f_lo, f_hi, n):
    """One harmonic voice of ``n`` samples with f0 in [f_lo, f_hi), an AM
    envelope and random phases, peak-normalised to 0.2."""
    f0 = rng.uniform(f_lo, f_hi)
    t = np.arange(n) / SR
    sig = np.zeros(n, np.float32)
    for h in range(1, 4):
        if f0 * h < SR / 2 * 0.9:
            sig += rng.uniform(0.3, 1.0) / h * np.sin(
                2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t
                             + rng.uniform(0, 2 * np.pi))
    sig = (sig * env).astype(np.float32)
    return 0.2 * sig / (np.abs(sig).max() + 1e-8)


def utterance(seed, n_src=2, noise_snr=None, lo=3.0, hi=3.0):
    """Utterance ``seed``'s (mixture, [sources]) as float32 arrays."""
    rng = np.random.default_rng(seed)
    T = int(rng.uniform(lo, hi) * SR)
    srcs = [voice(rng, *BANDS[s], T) for s in range(n_src)]
    mix = np.sum(srcs, axis=0)
    if noise_snr is not None:
        noise = rng.standard_normal(T).astype(np.float32)
        sig_pow = float(np.mean(mix ** 2)) + 1e-12
        noise *= np.sqrt(sig_pow / 10 ** (noise_snr / 10)
                         / (float(np.mean(noise ** 2)) + 1e-12))
        mix = mix + noise
    return mix.astype(np.float32), [s.astype(np.float32) for s in srcs]


def make_corpus(root, n_train=800, n_src=2, noise_snr=None, var_len=None,
                log=print):
    """Write the three splits under ``root``; ``var_len`` is ``(lo, hi)``
    seconds or None for a fixed 3 s. Returns the mixture channel's name
    (``mix_clean``, or ``mix_both`` with ``noise_snr``)."""
    if n_src > len(BANDS):
        raise ValueError(f"n_src {n_src} > {len(BANDS)} bands")
    mix_key = "mix_clean" if noise_snr is None else "mix_both"
    lo, hi = (float(v) for v in (var_len or (3.0, 3.0)))
    sizes = {"tr": n_train, "dev": N_HELD_OUT, "tt": N_HELD_OUT}
    for split, n in sizes.items():
        keys = [mix_key] + [f"s{i + 1}" for i in range(n_src)]
        infos = {k: [] for k in keys}
        for i in range(n):
            mix, srcs = utterance(SEEDS[split] + i, n_src, noise_snr, lo, hi)
            for ch, d in zip(keys, [mix] + srcs):
                p = os.path.join(root, split, ch, f"utt{i:04d}.wav")
                write_wav(p, d, SR)
                infos[ch].append([p, int(d.shape[-1])])
        for ch, lst in infos.items():
            with open(os.path.join(root, split, f"{ch}.json"), "w") as f:
                json.dump(lst, f)
        log(f"{split}: {n} utts (n_src={n_src}, mix={mix_key}, "
            f"len {lo}-{hi}s)")
    return mix_key


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("n_train", nargs="?", type=int, default=800)
    ap.add_argument("--n_src", type=int, default=2)
    ap.add_argument("--noise_snr", type=float, default=None,
                    help="add white noise to the mixture at this SNR (dB); "
                         "targets stay clean and the mixture manifest "
                         "becomes mix_both")
    ap.add_argument("--var_len", type=str, default="",
                    help="'lo,hi' seconds: per-utterance length uniform in "
                         "[lo, hi] (default: fixed 3 s)")
    args = ap.parse_args(argv)
    var_len = tuple(float(v) for v in args.var_len.split(",")) \
        if args.var_len else None
    make_corpus(args.out_root, args.n_train, args.n_src, args.noise_snr,
                var_len, log=lambda m: print(m, flush=True))


if __name__ == "__main__":
    main()
