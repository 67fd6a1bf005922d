"""Per-utterance eval metric trackers (counterpart of
``tdanet_tpu/metrics/wrapper.py``): PIT SI-SNR and its improvement over the
mixture, BSS-eval SDR and its improvement, written to a CSV with avg and std
footer rows. The SI-SNR runs through the port's PIT loss on torch tensors of
the inputs' dtype; BSS-eval on the host in float64."""

from __future__ import annotations

import csv

import numpy as np
import torch

from tdanet_tpu_torch.losses import (
    PITLossWrapper,
    pairwise_neg_sisdr,
    pairwise_neg_snr,
)
from tdanet_tpu_torch.metrics.bss_eval import sdr_pit


def _common(*arrays):
    """The arrays as numpy in their common dtype (a float32 reference
    beside a float64 estimate is compared in float64, as numpy would)."""
    arrays = [np.asarray(a) for a in arrays]
    dtype = np.result_type(*arrays)
    return [a.astype(dtype, copy=False) for a in arrays]


def _batch(x):
    """(n_src, T) numpy -> a (1, n_src, T) CPU tensor of its dtype."""
    return torch.from_numpy(np.ascontiguousarray(x))[None]


def _open_csv(save_file, columns):
    if not save_file:
        return None, None
    f = open(save_file, "w")
    writer = csv.DictWriter(f, fieldnames=columns)
    writer.writeheader()
    return f, writer


class MetricsTracker:
    COLUMNS = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i"]

    def __init__(self, save_file: str = ""):
        self.all_sdrs, self.all_sdrs_i = [], []
        self.all_sisnrs, self.all_sisnrs_i = [], []
        self.results_csv, self.writer = _open_csv(save_file, self.COLUMNS)
        # the reference's default threshold_byloss=True: a no-op at the
        # one utterance a call this tracker runs at
        self.pit_sisnr = PITLossWrapper(pairwise_neg_sisdr,
                                        pit_from="pw_mtx")

    def __call__(self, mix, clean, estimate, key):
        """mix (T,), clean (n_src, T), estimate (n_src, T)."""
        mix, clean, estimate = _common(mix, clean, estimate)
        n_src = clean.shape[0]
        mix_rep = np.stack([mix] * n_src, 0)

        sisnr = -float(self.pit_sisnr(_batch(estimate), _batch(clean)))
        sisnr_base = -float(self.pit_sisnr(_batch(mix_rep), _batch(clean)))
        sisnr_i = sisnr - sisnr_base

        # The reference's quirk, kept for parity with its numbers: it calls
        # fast_bss_eval's sdr_pit_loss(clean, estimate), CLEAN in the
        # estimate slot, so the clean sources are projected onto the
        # estimate's delay span; the baseline sdr_pit_loss(mix, clean) runs
        # in the normal direction. sdr_pit here is (refs, ests).
        sdr, _, _ = sdr_pit(estimate, clean)
        sdr_base, _, _ = sdr_pit(clean, mix_rep)
        sdr_i = sdr - sdr_base

        row = {"snt_id": key, "sdr": sdr, "sdr_i": sdr_i,
               "si-snr": sisnr, "si-snr_i": sisnr_i}
        if self.writer:
            self.writer.writerow(row)
        self.all_sdrs.append(sdr)
        self.all_sdrs_i.append(sdr_i)
        self.all_sisnrs.append(sisnr)
        self.all_sisnrs_i.append(sisnr_i)
        return row

    def update(self):
        return {"sdr_i": float(np.mean(self.all_sdrs_i)),
                "si-snr_i": float(np.mean(self.all_sisnrs_i))}

    def final(self):
        for name, fn in (("avg", np.mean), ("std", np.std)):
            row = {"snt_id": name,
                   "sdr": fn(self.all_sdrs), "sdr_i": fn(self.all_sdrs_i),
                   "si-snr": fn(self.all_sisnrs),
                   "si-snr_i": fn(self.all_sisnrs_i)}
            if self.writer:
                self.writer.writerow(row)
        if self.results_csv:
            self.results_csv.close()
        return self.update()


class SPlitMetricsTracker:
    """2+1-source split metrics: the three estimates are first reordered by
    a 3-source neg-SNR PIT, then SNR and SI-SNR (and their improvement over
    the stacked mixture) are taken on the reordered [0:2] block and on
    channel [2] apart. Exactly 3 sources, as the reference."""

    COLUMNS = ["snt_id", "one_snr", "one_snr_i", "one_si-snr",
               "one_si-snr_i", "two_snr", "two_snr_i", "two_si-snr",
               "two_si-snr_i"]

    def __init__(self, save_file: str = ""):
        self.acc = {c: [] for c in self.COLUMNS[1:]}
        self.results_csv, self.writer = _open_csv(save_file, self.COLUMNS)
        self.pit_sisnr = PITLossWrapper(pairwise_neg_sisdr,
                                        pit_from="pw_mtx")
        self.pit_snr = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx")

    def __call__(self, mix, clean, estimate, key):
        """mix (T,), clean (3, T), estimate (3, T)."""
        mix, clean, estimate = _common(mix, clean, estimate)
        cl, est = _batch(clean), _batch(estimate)
        _, ests = self.pit_snr(est, cl, return_ests=True)
        mix_rep = _batch(np.stack([mix] * clean.shape[0], 0))

        vals = {}
        for name, fn in (("si-snr", self.pit_sisnr), ("snr", self.pit_snr)):
            two = float(fn(ests[:, 0:2], cl[:, 0:2]))
            one = float(fn(ests[:, 2:3], cl[:, 2:3]))
            two_base = float(fn(mix_rep[:, 0:2], cl[:, 0:2]))
            one_base = float(fn(mix_rep[:, 2:3], cl[:, 2:3]))
            vals[f"two_{name}"] = -two
            vals[f"two_{name}_i"] = -(two - two_base)
            vals[f"one_{name}"] = -one
            vals[f"one_{name}_i"] = -(one - one_base)

        row = {"snt_id": key, **{c: vals[c] for c in self.COLUMNS[1:]}}
        if self.writer:
            self.writer.writerow(row)
        for c in self.COLUMNS[1:]:
            self.acc[c].append(vals[c])
        return row

    def update(self):
        return {"two_si-snr_i": float(np.mean(self.acc["two_si-snr_i"])),
                "one_si-snr_i": float(np.mean(self.acc["one_si-snr_i"]))}

    def final(self):
        for name, fn in (("avg", np.mean), ("std", np.std)):
            row = {"snt_id": name,
                   **{c: fn(self.acc[c]) for c in self.COLUMNS[1:]}}
            if self.writer:
                self.writer.writerow(row)
        if self.results_csv:
            self.results_csv.close()
        return self.update()
