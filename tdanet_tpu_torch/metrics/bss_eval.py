"""BSS-eval SDR with a time-invariant allowed-distortion filter
(counterpart of ``tdanet_tpu/metrics/bss_eval.py``).

For each (reference, estimate) pair the optimal length-L FIR projection of
the estimate onto the reference solves the Toeplitz normal equations
(Scheibler, "SDR — Medium Rare with Fast Computations", 2022, the algorithm
of fast_bss_eval), and

    SDR = 10 log10( coh / (1 - coh) ),
    coh = c^T R^{-1} c / ||est||^2 .

Host numpy and scipy: the metrics run per utterance during eval, on the
host, as the reference's fast_bss_eval does.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
from scipy.linalg import solve_toeplitz


def _acorr_xcorr(ref, est, L):
    """Autocorrelation of ref (lags 0..L-1) and crosscorr ref/est via FFT."""
    T = ref.shape[-1]
    n = 1
    while n < T + L:
        n *= 2
    R = np.fft.rfft(ref, n)
    E = np.fft.rfft(est, n)
    acorr = np.fft.irfft(R * np.conj(R), n)[..., :L]
    xcorr = np.fft.irfft(E * np.conj(R), n)[..., :L]
    return acorr, xcorr


def sdr_matrix(refs: np.ndarray, ests: np.ndarray, filter_length=512,
               eps=1e-10) -> np.ndarray:
    """(n_ref, T), (n_est, T) -> SDR matrix (n_est, n_ref) in dB."""
    refs = np.asarray(refs, np.float64)
    ests = np.asarray(ests, np.float64)
    n_ref, n_est = refs.shape[0], ests.shape[0]
    out = np.empty((n_est, n_ref))
    est_energy = np.sum(ests ** 2, axis=-1)
    for j in range(n_ref):
        acorr, _ = _acorr_xcorr(refs[j], refs[j], filter_length)
        for i in range(n_est):
            _, xcorr = _acorr_xcorr(refs[j], ests[i], filter_length)
            h = solve_toeplitz(acorr + eps * acorr[0], xcorr)
            num = float(np.dot(h, xcorr))
            coh = num / (est_energy[i] + eps)
            coh = min(max(coh, eps), 1.0 - 1e-12)
            out[i, j] = 10.0 * np.log10(coh / (1.0 - coh))
    return out


def sdr_pit(refs: np.ndarray, ests: np.ndarray, filter_length=512):
    """PIT BSS-eval SDR: (mean SDR of the best permutation, per-source SDR,
    permutation). Exhaustive search for n <= 3, scipy's Hungarian
    assignment above."""
    mat = sdr_matrix(refs, ests, filter_length)
    n = mat.shape[0]
    if n <= 3:
        best_perm = max(permutations(range(n)),
                        key=lambda pm: sum(mat[i, p]
                                           for i, p in enumerate(pm)))
    else:
        from scipy.optimize import linear_sum_assignment
        best_perm = tuple(linear_sum_assignment(-mat)[1])
    per_src = np.array([mat[i, p] for i, p in enumerate(best_perm)])
    return float(per_src.mean()), per_src, best_perm
