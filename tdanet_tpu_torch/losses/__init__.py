"""Losses: the PIT wrapper and the SDR family (counterpart of
``tdanet_tpu/losses``)."""

from tdanet_tpu_torch.losses.pit import (  # noqa: F401
    PITLossWrapper, find_best_perm, find_best_perm_factorial,
    find_best_perm_hungarian, reorder_sources)
from tdanet_tpu_torch.losses.sisnri import SISNRi, sisnr_improvement  # noqa
from tdanet_tpu_torch.losses.sdr import (  # noqa: F401
    MultiSrcNegSDR, PairwiseNegSDR, SingleSrcNegSDR, freq_mae_wavl1,
    freq_mae_wavl1loss, multisrc_neg_sdr, multisrc_neg_sdsdr,
    multisrc_neg_sisdr, multisrc_neg_snr, pairwise_neg_sdr,
    pairwise_neg_sdsdr, pairwise_neg_sisdr, pairwise_neg_snr,
    singlesrc_neg_sdr, singlesrc_neg_sdsdr, singlesrc_neg_sisdr,
    singlesrc_neg_snr)

__all__ = [
    "PITLossWrapper", "find_best_perm", "find_best_perm_factorial",
    "find_best_perm_hungarian", "reorder_sources", "freq_mae_wavl1",
    "multisrc_neg_sdr", "multisrc_neg_sdsdr", "multisrc_neg_sisdr",
    "multisrc_neg_snr", "pairwise_neg_sdr", "pairwise_neg_sdsdr",
    "pairwise_neg_sisdr", "pairwise_neg_snr", "singlesrc_neg_sdr",
    "singlesrc_neg_sdsdr", "singlesrc_neg_sisdr", "singlesrc_neg_snr",
    "SISNRi", "sisnr_improvement", "PairwiseNegSDR", "SingleSrcNegSDR",
    "MultiSrcNegSDR", "freq_mae_wavl1loss",
]
