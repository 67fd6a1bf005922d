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
                         threshold=0.05, batch_size=8, compute_dtype=None,
                         mesh=None):
    """Adaptive-depth separation of ``mixes`` (N, T), mixtures of one
    length, on the model's device: the stage-1 sweep in batches of
    ``batch_size``, the threshold census, the gather of the escalated rows
    on the device, stage 2 on them. Returns ``(ests, info)``: ``ests``
    (N, n_src, T) numpy in input order, in the model's dtype (bf16 upcast
    to float32); ``info`` holds each utterance's ``delta`` (in the same
    dtype), the boolean ``escalated`` mask, ``n_escalated`` and the two
    depths. ``compute_dtype`` (e.g. torch.bfloat16) is the activations'
    dtype, as ``TDANetBest.forward`` takes it: stage 1 runs in it and
    stage 2 continues its state; the estimates and deltas are then in it
    (bf16 upcast to float32).

    ``threshold``: escalate the utterances whose delta is above it; 0 or
    below escalates all of them (the full-depth forward, for A/Bs),
    ``np.inf`` none (the depth-d1 forward).

    ``mesh`` (a local ``parallel.make_mesh``): dp scale-out, as
    ``separate_batched`` does it. Every stage-1 and stage-2 batch is padded
    to ``batch_size`` rows, a multiple of dp; replica i runs its rows on
    its device; states and estimates are concatenated in row order on the
    first replica's device, where the escalated rows are gathered."""
    rows = replicas = None
    if mesh is not None:
        from tdanet_tpu_torch.parallel import dp_batch_setup
        rows, replicas = dp_batch_setup(mesh, batch_size, model)
    return _progressive(model, mixes, depth1, depth_full, threshold,
                        batch_size, rows, replicas, compute_dtype)


def _progressive(model, mixes, depth1, depth_full, threshold, batch_size,
                 rows=None, replicas=None, compute_dtype=None):
    """:func:`separate_progressive` on one device, or over ``replicas``
    (each running its ``rows`` of a batch) when they are given."""
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

    def stage1(rep, xb):
        return rep.forward_stage1(xb, depth1, per_utterance=True,
                                  compute_dtype=compute_dtype)

    def stage2(rep, st):
        return rep.forward_stage2(st, n_more, rest, per_utterance=True)

    if replicas is None:
        return progressive_loop(
            lambda xb: stage1(model, xb), lambda st: stage2(model, st),
            mixes, batch_size, threshold, next(model.parameters()).device,
            depth1=depth1, depth_full=depth_full)
    home = next(replicas[0].parameters()).device
    return progressive_loop(
        _split_stage(stage1, replicas, rows, batch_size, home),
        _split_stage(stage2, replicas, rows, batch_size, home),
        mixes, batch_size, threshold, home, depth1=depth1,
        depth_full=depth_full)


def _split_stage(stage, replicas, rows, batch_size, home):
    """A stage over a mesh's replicas: its input (a (rows, T) tensor or a
    state dict with the batch first) padded to ``batch_size`` rows with
    copies of the last row, replica i's rows run by ``stage(replica_i,
    part)`` on its device, the outputs (tensors, or ``(est, state)``)
    concatenated in row order on ``home`` and cut to the rows given."""

    def pad_rows(t):
        extra = batch_size - t.shape[0]
        return torch.cat([t, t[-1:].expand(extra, *t.shape[1:])]) \
            if extra else t

    def part(v, sl, device):
        return v[sl].to(device) if torch.is_tensor(v) else v

    def cat(vs, n):
        if isinstance(vs[0], dict):
            return {k: cat([v[k] for v in vs], n) for k in vs[0]}
        if isinstance(vs[0], tuple):
            return tuple(cat([v[i] for v in vs], n)
                         for i in range(len(vs[0])))
        if torch.is_tensor(vs[0]):
            return torch.cat([v.to(home) for v in vs])[:n]
        return vs[0]

    def run(inp):
        if isinstance(inp, dict):
            n = next(v for v in inp.values() if torch.is_tensor(v)).shape[0]
            inp = {k: pad_rows(v) if torch.is_tensor(v) else v
                   for k, v in inp.items()}
        else:
            n, inp = inp.shape[0], pad_rows(inp)
        outs = []
        for rep, sl in zip(replicas, rows):
            device = next(rep.parameters()).device
            if isinstance(inp, dict):
                outs.append(stage(rep, {k: part(v, sl, device)
                                        for k, v in inp.items()}))
            else:
                outs.append(stage(rep, part(inp, sl, device)))
        return cat(outs, n)

    return run


def progressive_loop(stage1, stage2, mixes, batch_size, threshold, device,
                     *, depth1, depth_full):
    """The host orchestration shared by :func:`separate_progressive` and
    a deployment bundle's stage pair (``deploy.load_progressive``): the
    stage-1 sweep in batches of ``batch_size`` rows (the last may be
    shorter), the threshold census, the gather of the escalated rows on
    ``device`` (``index_select`` on the concatenated state) and stage 2 on
    them. ``stage1`` maps a (rows, T) float32 tensor on ``device`` to
    ``(est, state)``, ``state`` a dict whose tensors have the batch first
    and which holds ``delta``; ``stage2`` maps such a state of the
    escalated rows to their estimates. Returns ``(ests, info)`` as
    :func:`separate_progressive` does."""
    mixes = np.asarray(mixes, np.float32)
    N = mixes.shape[0]
    ests = np.zeros((0,), np.float32)
    deltas = np.zeros(0, np.float32)
    with torch.inference_mode():
        states = []
        for s0 in range(0, N, batch_size):
            xb = torch.from_numpy(mixes[s0:s0 + batch_size]).to(device)
            est, st = stage1(xb)
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
                ests[chunk] = to_numpy(stage2(st))
    return ests, {"delta": deltas, "escalated": escalated,
                  "depth1": depth1, "depth_full": depth_full,
                  "n_escalated": int(escalated.sum())}


def separate_progressive_stream(model, lengths, get_item, depth1=8,
                                depth_full=None, threshold=0.05,
                                batch_size=8, group_size=None, stats=None,
                                compute_dtype=None, mesh=None):
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
    ``depth1``, ``depth_full``. ``compute_dtype``: the activations' dtype,
    as :func:`separate_progressive` takes it. ``mesh``: dp scale-out,
    passed to :func:`separate_progressive` (``batch_size`` a multiple of
    dp)."""
    rows = replicas = None
    if mesh is not None:  # one set-up for the whole stream
        from tdanet_tpu_torch.parallel import dp_batch_setup
        rows, replicas = dp_batch_setup(mesh, batch_size, model)
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
            ests, info = _progressive(model, mixes, depth1, depth_full,
                                      threshold, batch_size, rows, replicas,
                                      compute_dtype)
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
