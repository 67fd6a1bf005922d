"""Progressive (adaptive-depth) batched separation (counterpart of
``tdanet_tpu/progressive.py``).

TDANetBest applies one shared-weight UConvBlock ``num_blocks`` times. A
fixed lower depth pays its quality cost on every utterance; here the depth
adapts per utterance, with no approximation on the escalated path:

1. stage 1: every utterance runs at a cheap depth d1, and the recurrence
   also gives each example's convergence proxy
   ``delta = ||x_d1 - x_{d1-1}|| / (||x_d1|| + 1e-8)``;
2. stage 2: the utterances with ``delta > threshold`` continue, exactly,
   from the saved carry through the same body to full depth (stage 1 +
   stage 2 is the full-depth forward).

Cost: N d1 + N_escalated (d_full - d1) block iterations instead of
N d_full. Stage 1's state stays on the model's device; the escalated rows
are gathered there (``index_select``) into full batches, so host-device
traffic is mixtures in, estimates and one delta a row out. Every row is
separated as if alone (``per_utterance=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from tdanet_tpu_torch.utils.separator import (PREFETCH_BATCHES,
                                              plan_lattice_buckets,
                                              start_prefetch_reader,
                                              take_item, to_numpy,
                                              trim_renorm)


def separate_progressive(model, mixes, depth1=8, depth_full=None,
                         threshold=0.05, batch_size=8):
    """Adaptive-depth separation of ``mixes`` (N, T), mixtures of one
    length, on the model's device: the stage-1 sweep in batches of
    ``batch_size``, the threshold census, the gather of the escalated rows
    on the device, stage 2 on them. Returns ``(ests, info)``: ``ests``
    (N, n_src, T) numpy in input order, in the model's dtype (bf16 upcast
    to float32); ``info`` holds each utterance's ``delta`` (in the same
    dtype), the boolean ``escalated`` mask, ``n_escalated`` and the two
    depths.

    ``threshold``: escalate the utterances whose delta is above it; 0 or
    below escalates all of them (the full-depth forward, for A/Bs),
    ``np.inf`` none (the depth-d1 forward)."""
    if not hasattr(model, "forward_stage1"):
        raise TypeError(
            f"progressive separation needs a model with the staged forward "
            f"(forward_stage1/forward_stage2/pad_rest, as TDANetBest has); "
            f"{type(model).__name__} has none. Use "
            f"utils.separator.separate_batched for other models.")
    mixes = np.asarray(mixes, np.float32)
    N, T = mixes.shape
    depth_full = depth_full if depth_full is not None else model.num_blocks
    if depth_full > model.num_blocks:
        raise ValueError(
            f"depth_full ({depth_full}) exceeds the trained depth "
            f"({model.num_blocks})")
    n_more = depth_full - depth1
    if n_more <= 0:
        raise ValueError(f"depth_full ({depth_full}) must exceed "
                         f"depth1 ({depth1})")
    rest = model.pad_rest(T)
    device = next(model.parameters()).device
    ests = np.zeros((0, model.num_sources, T), np.float32)
    deltas = np.zeros(0, np.float32)
    with torch.inference_mode():
        states = []
        for s0 in range(0, N, batch_size):
            xb = torch.from_numpy(mixes[s0:s0 + batch_size]).to(device)
            est, st = model.forward_stage1(xb, depth1, per_utterance=True)
            est, delta = to_numpy(est), to_numpy(st["delta"])
            if s0 == 0:
                ests = np.zeros((N, *est.shape[1:]), est.dtype)
                deltas = np.zeros(N, delta.dtype)
            ests[s0:s0 + len(est)] = est
            deltas[s0:s0 + len(est)] = delta
            states.append(st)

        # threshold <= 0 is the documented "escalate everything" mode: a
        # strict > would keep exact-zero deltas (all-silent inputs)
        escalated = (deltas > threshold) if threshold > 0 else \
            np.ones(N, bool)
        hard = np.where(escalated)[0]
        if len(hard):
            # utterance i is row i of the concatenated stage-1 state
            cat = {k: (torch.cat([s[k] for s in states])
                       if torch.is_tensor(v) else v)
                   for k, v in states[0].items()}
            del states
            for c0 in range(0, len(hard), batch_size):
                chunk = hard[c0:c0 + batch_size]
                idx = torch.from_numpy(chunk).to(device)
                st = {k: (v.index_select(0, idx) if torch.is_tensor(v)
                          else v) for k, v in cat.items()}
                ests[chunk] = to_numpy(model.forward_stage2(
                    st, n_more, rest, per_utterance=True))
    return ests, {"delta": deltas, "escalated": escalated,
                  "depth1": depth1, "depth_full": depth_full,
                  "n_escalated": int(escalated.sum())}


def separate_progressive_stream(model, lengths, get_item, depth1=8,
                                depth_full=None, threshold=0.05,
                                batch_size=8, group_size=None, stats=None):
    """Adaptive-depth eval stream over variable-length utterances, the
    progressive counterpart of
    :func:`tdanet_tpu_torch.utils.separator.separate_batched_stream`, with
    its interface: ``lengths[i]`` plans the buckets without loading audio,
    ``get_item(i)`` is prefetched on a reader thread, and it yields
    ``(i, item, est)`` with ``est`` trimmed and renormalised by
    ``trim_renorm``.

    Utterances are bucketed on the model's stride lattice and processed in
    groups of ``group_size`` (default ``4 * batch_size``), so stage-2
    escalations pool across the group's stage-1 batches.

    ``stats`` (optional dict) is updated in place with the escalation
    census: ``n``, ``n_escalated``, ``delta_sum``, ``delta_mean``,
    ``depth1``, ``depth_full``."""
    group = group_size or 4 * batch_size
    plan = plan_lattice_buckets(lengths, model.lcm, group)
    if stats is not None:
        stats.update(n=0, n_escalated=0, delta_sum=0.0, delta_mean=0.0,
                     depth1=depth1,
                     depth_full=(depth_full if depth_full is not None
                                 else model.num_blocks))
    q, close = start_prefetch_reader(plan, get_item,
                                     PREFETCH_BATCHES * batch_size)
    try:
        for target, chunk in plan:
            items = [take_item(q) for _ in chunk]
            mixes = np.zeros((len(chunk), target), np.float32)
            for row, it in enumerate(items):
                w = np.asarray(it[0], np.float32)
                mixes[row, :w.shape[-1]] = w
            ests, info = separate_progressive(
                model, mixes, depth1=depth1, depth_full=depth_full,
                threshold=threshold, batch_size=batch_size)
            if stats is not None:
                stats["n"] += len(chunk)
                stats["n_escalated"] += info["n_escalated"]
                stats["delta_sum"] += float(info["delta"].sum())
                stats["delta_mean"] = stats["delta_sum"] / stats["n"]
            for row, i in enumerate(chunk):
                mix = np.asarray(items[row][0], np.float32)
                yield i, items[row], trim_renorm(mix, ests[row])
    finally:
        close()
