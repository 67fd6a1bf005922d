"""Eval metrics: PIT SI-SNR(i), BSS-eval SDR(i), CSV trackers (counterpart
of ``tdanet_tpu/metrics``)."""

from tdanet_tpu_torch.metrics.bss_eval import sdr_matrix, sdr_pit
from tdanet_tpu_torch.metrics.wrapper import MetricsTracker, \
    SPlitMetricsTracker

__all__ = ["sdr_matrix", "sdr_pit", "MetricsTracker", "SPlitMetricsTracker"]
