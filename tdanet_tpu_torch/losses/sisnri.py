"""SI-SNR improvement (counterpart of ``tdanet_tpu/losses/sisnri.py``)."""

from __future__ import annotations

from itertools import permutations

import torch


def sisnr_improvement(mix, est, ref, eps: float = 1e-8):
    """Per-utterance SI-SNR(est) - SI-SNR(mix) against ref; all (B, L) ->
    (B, 1)."""
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    mix = mix - mix.mean(dim=-1, keepdim=True)
    ref_energy = (ref * ref).sum(dim=-1, keepdim=True)
    est_p = (est * ref).sum(dim=-1, keepdim=True) * ref / ref_energy
    est_v = est - est_p
    mix_p = (mix * ref).sum(dim=-1, keepdim=True) * ref / ref_energy
    mix_v = mix - mix_p

    def snr(p, v):
        return 10 * torch.log10(
            ((p * p).sum(dim=-1, keepdim=True) + eps)
            / ((v * v).sum(dim=-1, keepdim=True) + eps))

    return snr(est_p, est_v) - snr(mix_p, mix_v)


class SISNRi:
    """PIT-max SI-SNRi loss: the negated mean of the best permutation's
    improvement."""

    def sisnr(self, mix, est, ref, eps=1e-8):
        return sisnr_improvement(mix, est, ref, eps)

    def compute_loss(self, mix, ests, refs):
        rows = []
        for perm in permutations(range(len(ests))):
            vals = torch.stack([self.sisnr(mix, ests[s], refs[t])
                                for s, t in enumerate(perm)])
            rows.append(vals.mean(dim=0, keepdim=True))
        return -torch.amax(torch.stack(rows), dim=0).mean()

    __call__ = compute_loss
