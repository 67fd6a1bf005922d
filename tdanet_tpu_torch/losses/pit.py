"""Permutation-invariant training wrapper (counterpart of
``tdanet_tpu/losses/pit.py``).

For n_src <= 3 the best permutation is a search over all of them (a
one-hot contraction); for more sources the Hungarian assignment of scipy
runs on the host on a detached copy of the cost matrix, and the loss is
gathered from the matrix on the device, so it stays differentiable. The
minimum over permutations spreads its gradient evenly over ties, as
``jnp.min`` does.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np
import torch

from tdanet_tpu_torch.parallel import collectives


def _perm_tensor(n_src):
    return np.array(list(permutations(range(n_src))), dtype=np.int64)


def find_best_perm_factorial(pair_wise_losses):
    """(B, est, tgt) -> (min_loss (B,), batch_indices (B, n_src)): the
    estimate for each target."""
    n_src = pair_wise_losses.shape[-1]
    pwl = pair_wise_losses.transpose(-1, -2)  # (B, tgt, est)
    perms = _perm_tensor(n_src)
    one_hot = np.zeros((len(perms), n_src, n_src))
    for p_i, perm in enumerate(perms):
        one_hot[p_i, np.arange(n_src), perm] = 1.0
    one_hot = torch.from_numpy(one_hot).to(pwl)
    loss_set = torch.einsum("bij,pij->bp", pwl, one_hot) / n_src
    min_loss = torch.amin(loss_set, dim=1)
    idx = torch.argmin(loss_set, dim=1)
    return min_loss, torch.from_numpy(perms).to(pwl.device)[idx]


def find_best_perm_hungarian(pair_wise_losses):
    """The Hungarian assignment (scipy, on the host) for n_src > 3; the
    returned min_loss is gathered from the matrix, so gradients flow."""
    from scipy.optimize import linear_sum_assignment

    pwl = pair_wise_losses.transpose(-1, -2)
    cost = pwl.detach().cpu().double().numpy()
    idx = np.stack([linear_sum_assignment(m)[1] for m in cost])
    batch_indices = torch.from_numpy(idx.astype(np.int64)).to(pwl.device)
    min_loss = torch.take_along_dim(pwl, batch_indices[..., None],
                                    dim=2).mean(dim=(-1, -2))
    return min_loss, batch_indices


def find_best_perm(pair_wise_losses):
    if pair_wise_losses.shape[-1] <= 3:
        return find_best_perm_factorial(pair_wise_losses)
    return find_best_perm_hungarian(pair_wise_losses)


def reorder_sources(sources, batch_indices):
    """Apply per-batch permutations: out[b, i] = sources[b, idx[b, i]]."""
    return torch.take_along_dim(sources, batch_indices[..., None], dim=1)


class PITLossWrapper:
    """The reference wrapper's modes ``pw_mtx`` (the loss gives the
    pairwise matrix), ``pw_pt`` (a single-source loss over every pair) and
    ``perm_avg`` (a multi-source loss over every permutation);
    ``threshold_byloss`` averages only the utterances whose loss is above
    -30 dB, and all of them when none is.

    ``dp_group`` (a call's keyword): the data-parallel group whose ranks
    hold the rest of the global batch. The mean is then the global batch's:
    the count of kept utterances, and whether any is kept, are summed over
    ranks (without a gradient), each rank divides its own sum by the
    global count, and the returned loss is the sum of the ranks' terms
    (``collectives.global_sum``): the same value on every rank, whose
    gradient reaches each rank's own utterances."""

    def __init__(self, loss_func, pit_from="pw_mtx", perm_reduce=None,
                 threshold_byloss=True):
        if pit_from not in ("pw_mtx", "pw_pt", "perm_avg"):
            raise ValueError(f"Unsupported pit_from {pit_from!r}")
        self.loss_func = loss_func
        self.pit_from = pit_from
        self.perm_reduce = perm_reduce
        self.threshold_byloss = threshold_byloss

    def __call__(self, ests, targets, return_ests=False, dp_group=None,
                 **kwargs):
        n_src = targets.shape[1]
        if self.pit_from == "pw_mtx":
            pw_loss = self.loss_func(ests, targets, **kwargs)
        elif self.pit_from == "pw_pt":
            pw_loss = self._pw_losses(ests, targets, **kwargs)
        else:  # perm_avg
            perms = _perm_tensor(n_src)
            loss_set = torch.stack(
                [self.loss_func(ests[:, list(p)], targets, **kwargs)
                 for p in perms], dim=1)
            min_loss = torch.amin(loss_set, dim=1)
            idx = torch.argmin(loss_set, dim=1)
            mean_loss = _mean(min_loss, dp_group)
            if return_ests:
                batch_indices = torch.from_numpy(perms).to(ests.device)[idx]
                return mean_loss, reorder_sources(ests, batch_indices)
            return mean_loss

        assert pw_loss.ndim == 3
        min_loss, batch_indices = find_best_perm(pw_loss)
        if self.threshold_byloss:
            mask = min_loss > -30.0
            cnt = collectives.all_sum(mask.sum(), dp_group)
            masked = torch.where(mask, min_loss, torch.zeros_like(
                min_loss)).sum() / torch.clamp(cnt, min=1)
            mean_loss = collectives.global_sum(
                torch.where(cnt > 0, masked, _local_mean(min_loss,
                                                         dp_group)),
                dp_group)
        else:
            mean_loss = _mean(min_loss, dp_group)
        if return_ests:
            return mean_loss, reorder_sources(ests, batch_indices)
        return mean_loss

    def _pw_losses(self, ests, targets, **kwargs):
        """Every (estimate, target) pair through a single-source loss."""
        B, n_src, T = targets.shape
        e = ests.repeat_interleave(n_src, dim=1).reshape(B * n_src * n_src,
                                                         T)
        t = targets.repeat(1, n_src, 1).reshape(B * n_src * n_src, T)
        return self.loss_func(e, t, **kwargs).reshape(B, n_src, n_src)


def _local_mean(x, dp_group):
    """This rank's term of the global batch's mean of ``x``: its sum over
    the global row count (the mean itself on one process)."""
    _, world = collectives.rank_and_world(dp_group)
    if world == 1:
        return x.mean()
    return x.sum() / (x.shape[0] * world)


def _mean(x, dp_group):
    """The global batch's mean of the per-utterance ``x``."""
    return collectives.global_sum(_local_mean(x, dp_group), dp_group)
