"""Continuous speech separation: stitching (counterpart of
``tdanet_tpu/utils/css.py``). The segments of a long-form recording are
separated as independent rows, then joined by overlap-add with the
permutation of each segment chosen by the cosine similarity across the
overlap. Optionally the per-segment forward is progressive (adaptive
depth, ``tdanet_tpu_torch/progressive.py``)."""

from __future__ import annotations

import numpy as np
import torch

from tdanet_tpu_torch.utils.separator import to_numpy


def _cos(a, b, eps=1e-8):
    return float(np.dot(a, b) /
                 ((np.linalg.norm(a) * np.linalg.norm(b)) + eps))


def separate_segments(model, segments, batch_size=8,
                      progressive_depth=None, progressive_threshold=0.05):
    """Separate ``segments`` (a list of (L,) arrays of one length) on the
    model's device, every segment as if alone, ``batch_size`` a forward.
    Returns (K, n_src, L) numpy in the model's dtype (bf16 upcast to
    float32). The result does not depend on ``batch_size``. There is no
    lattice padding and no renormalisation, as in the reference's
    segment loop."""
    segs = np.stack([np.asarray(s, np.float32) for s in segments])
    if progressive_depth is not None:
        from tdanet_tpu_torch.progressive import separate_progressive
        est, _ = separate_progressive(model, segs, depth1=progressive_depth,
                                      threshold=progressive_threshold,
                                      batch_size=batch_size)
        return est
    p = next(model.parameters())
    out = []
    with torch.inference_mode():
        for s0 in range(0, len(segs), batch_size):
            x = torch.from_numpy(segs[s0:s0 + batch_size]).to(p.device,
                                                              p.dtype)
            out.append(to_numpy(model(x, per_utterance=True)))
    return np.concatenate(out)


def stitch_segments(model, segments, overlap_len: int,
                    progressive_depth: int | None = None,
                    progressive_threshold: float = 0.05,
                    batch_size: int = 8) -> np.ndarray:
    """segments: list of (seg_len,) arrays -> stitched (n_src, total_len).

    ``progressive_depth``: if set, segments are separated adaptively:
    stage 1 at this depth, the exact continuation to full depth for those
    whose convergence proxy exceeds ``progressive_threshold``."""
    est = separate_segments(model, segments, batch_size, progressive_depth,
                            progressive_threshold)
    return stitch_chain(est, overlap_len)


def chain_swaps(est: np.ndarray, overlap_len: int) -> list:
    """The permutation chain's decisions over pre-separated segments
    ``est`` (K, 2, L): for each segment k > 0, whether its two sources are
    swapped. The reference's two quirks are kept:

    - the comparison tails are frozen at segment 0's estimates, so every
      segment aligns against segment 0, not its predecessor;
    - a tied score swaps (the reference keeps the order only when the
      keep score is strictly greater)."""
    K, n_src, L = est.shape
    assert n_src == 2, "reference stitching is defined for 2 sources"
    if K > 1 and overlap_len < 1:
        raise ValueError("stitching needs overlap_len >= 1 "
                         "(got 0: use a nonzero --overlap)")
    tail1, tail2 = est[0, 0][-overlap_len:], est[0, 1][-overlap_len:]
    swaps = []
    for k in range(1, K):
        s1, s2 = est[k, 0], est[k, 1]
        comb1 = _cos(tail1, s1[:overlap_len]) + _cos(tail2, s2[:overlap_len])
        comb2 = _cos(tail1, s2[:overlap_len]) + _cos(tail2, s1[:overlap_len])
        swaps.append(not comb1 > comb2)
    return swaps


def stitch_chain(est: np.ndarray, overlap_len: int) -> np.ndarray:
    """Join pre-separated segments ``est`` (K, 2, L) into (2, total_len):
    segment 0 whole, then each later segment past its overlap, in the
    order :func:`chain_swaps` decides."""
    out1, out2 = [est[0, 0]], [est[0, 1]]
    for k, swap in enumerate(chain_swaps(est, overlap_len), start=1):
        s1, s2 = est[k, 0], est[k, 1]
        if swap:
            s1, s2 = s2, s1
        out1.append(s1[overlap_len:])
        out2.append(s2[overlap_len:])
    return np.stack([np.concatenate(out1), np.concatenate(out2)])
