"""High-level separation helpers (counterpart of
``tdanet_tpu/utils/separator.py``): pad to the model's stride lattice,
separate on the model's device, trim, and renormalise each utterance's
output energy to its mixture's over the true region."""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

# how many batches of audio the eval streams' reader reads ahead
PREFETCH_BATCHES = 2


def depth_kw(num_blocks):
    """The forward's early-exit keyword: none at the full depth, so a
    model without early exit (the TDANet variants) runs, and raises
    TypeError only when a depth is asked for, as in the JAX package."""
    return {} if num_blocks is None else {"num_blocks": num_blocks}


def _device_dtype(model):
    p = next(model.parameters())
    return p.device, p.dtype


def to_numpy(t):
    """A tensor on any device as numpy; numpy has no bf16, so bf16 is
    upcast to float32 and other dtypes kept."""
    return t.to(torch.promote_types(t.dtype, torch.float32)).cpu().numpy()


def separate(model, wav, lattice=None, num_blocks=None):
    """wav: (T,) or (B, T) numpy or torch -> separated (n_src, T) or
    (B, n_src, T), numpy for numpy input.

    Runs on the model's device, in its dtype. A 2-D input is one batch and
    keeps the reference's batch-axis attention across its rows, as the JAX
    package's ``separate`` does; use :func:`separate_batched` for
    independent utterances."""
    is_numpy = not torch.is_tensor(wav)
    device, dtype = _device_dtype(model)
    x = torch.as_tensor(np.asarray(wav, np.float32) if is_numpy else wav)
    x = x.to(device=device, dtype=dtype)
    was_1d = x.ndim == 1
    if was_1d:
        x = x[None]
    T = x.shape[-1]
    lattice = lattice or getattr(model, "lcm", 1)
    target = -(-T // lattice) * lattice
    with torch.inference_mode():
        xp = torch.nn.functional.pad(x, (0, target - T))
        out = model(xp, **depth_kw(num_blocks))[..., :T]
        # per-utterance energy renormalisation over the true region
        scale = x.abs().sum(-1)[:, None, None] / (
            out.abs().sum((-1, -2))[:, None, None] + 1e-8)
        out = out * scale
    if was_1d:
        out = out[0]
    return to_numpy(out) if is_numpy else out


def plan_lattice_buckets(lengths, lattice, group):
    """Bucket utterance indices by their length padded up to ``lattice``,
    then split every bucket into chunks of at most ``group`` indices.
    Returns ``[(padded_len, [idx, ...]), ...]``, buckets in length order,
    input order kept within a bucket."""
    buckets = {}
    for i, length in enumerate(lengths):
        target = -(-int(length) // lattice) * lattice
        buckets.setdefault(target, []).append(i)
    plan = []
    for target, idxs in sorted(buckets.items()):
        for s in range(0, len(idxs), group):
            plan.append((target, idxs[s:s + group]))
    return plan


def trim_renorm(mix, est_row):
    """Trim a padded (n_src, T_pad) estimate to the mixture's length and
    renormalise its energy to the mixture's over the true region."""
    T = mix.shape[-1]
    out = est_row[:, :T]
    # both sums in the estimate's precision, as separate takes them
    scale = np.abs(mix).sum(dtype=out.dtype) / (np.abs(out).sum() + 1e-8)
    return out * scale


def start_prefetch_reader(plan, get_item, depth):
    """Start the eval stream's reader thread: it calls ``get_item(i)`` for
    every index of ``plan`` in order, at most ``depth`` items ahead of the
    consumer. Returns ``(queue, close)``; take each item with
    :func:`take_item`, and call ``close()`` when done, early or not: it
    stops the reader and joins it. The thread only reads (audio IO); every
    CUDA call stays on the consumer's thread."""
    q = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def reader():
        try:
            for _target, chunk in plan:
                for i in chunk:
                    if not put(get_item(i)):
                        return
        except Exception as e:  # the consumer raises it at its next take
            put(_ReadError(e))

    t = threading.Thread(target=reader, daemon=True)
    t.start()

    def close():
        stop.set()
        t.join()

    return q, close


class _ReadError:
    def __init__(self, error):
        self.error = error


def take_item(q):
    """The reader's next item; re-raises an error the reader hit."""
    item = q.get()
    if isinstance(item, _ReadError):
        raise item.error
    return item


def _dispatch(model, batch, num_blocks, compute_dtype=None):
    """Queue one padded (rows, T) numpy batch's forward, every row as if
    alone, in ``compute_dtype`` (else the model's dtype), and the copy of
    its estimates to the host. On the card both are
    asynchronous: the copy lands in pinned memory and the returned event
    marks it done. Returns ``(host_tensor, event or None)``."""
    device, dtype = _device_dtype(model)
    x = torch.from_numpy(batch)
    cuda = device.type == "cuda"
    if cuda:
        x = x.pin_memory()
    with torch.inference_mode():
        x = x.to(device=device, dtype=dtype, non_blocking=cuda)
        est = model(x, per_utterance=True, compute_dtype=compute_dtype,
                    **depth_kw(num_blocks))
        est = est.to(torch.promote_types(est.dtype, torch.float32))
        if not cuda:
            return est, None
        host = torch.empty(est.shape, dtype=est.dtype, pin_memory=True)
        host.copy_(est, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def separate_batched_stream(model, lengths, get_item, batch_size=8,
                            lattice=None, num_blocks=None,
                            compute_dtype=None):
    """Separate a corpus in lattice-length buckets, ``batch_size``
    utterances a forward, with audio IO and host work overlapping the card.

    - ``lengths[i]`` is utterance i's sample count, known without loading
      it (manifests carry it), so the buckets are planned up front;
    - a reader thread prefetches ``get_item(i)`` in processing order,
      ``PREFETCH_BATCHES`` batches ahead;
    - the pipeline is one batch deep: batch k+1's forward is queued on the
      card before batch k's estimates are read on the host, so the
      caller's metrics and wav IO for batch k overlap batch k+1.

    Every row is separated as if alone (``per_utterance=True``), so a
    result does not depend on the rows it shares a batch with; a ragged
    last chunk runs with its own row count. Yields ``(i, item, est)`` in
    bucket order (buckets by length, corpus order within one), ``est`` the
    (n_src, T_i) numpy estimate trimmed and renormalised by
    :func:`trim_renorm`; ``item`` is what ``get_item`` returned, whose
    first element is the mixture. ``compute_dtype`` (e.g.
    torch.bfloat16) is the forward's activation dtype, as
    ``TDANetBest.forward`` takes it; bf16 estimates come back as float32."""
    lattice = lattice or getattr(model, "lcm", 1)
    plan = plan_lattice_buckets(lengths, lattice, batch_size)
    q, close = start_prefetch_reader(plan, get_item,
                                     PREFETCH_BATCHES * batch_size)

    def materialize(chunk, items, host, event):
        if event is not None:
            event.synchronize()
        est = host.numpy()
        for row, i in enumerate(chunk):
            mix = np.asarray(items[row][0], np.float32)
            yield i, items[row], trim_renorm(mix, est[row])

    try:
        pending = None
        for target, chunk in plan:
            items = [take_item(q) for _ in chunk]
            batch = np.zeros((len(chunk), target), np.float32)
            for row, it in enumerate(items):
                w = np.asarray(it[0], np.float32)
                batch[row, :w.shape[-1]] = w
            result = _dispatch(model, batch, num_blocks, compute_dtype)
            if pending is not None:
                yield from materialize(*pending)
            pending = (chunk, items, *result)
        if pending is not None:
            yield from materialize(*pending)
    finally:
        close()


def separate_batched(model, wavs, batch_size=8, lattice=None,
                     num_blocks=None, compute_dtype=None):
    """Separate variable-length utterances in lattice-length buckets,
    ``batch_size`` at a time (:func:`separate_batched_stream`). Every row
    is separated as if alone (the per-utterance attention collapse), so
    results do not depend on which utterances share a batch. Returns numpy
    (n_src, T_i) estimates in input order, in the model's dtype (bf16
    upcast to float32, as in :func:`separate`), or in ``compute_dtype``
    when it is given."""
    wavs = [np.asarray(w, np.float32) for w in wavs]
    outputs = [None] * len(wavs)
    for i, _, est in separate_batched_stream(
            model, [w.shape[-1] for w in wavs], lambda i: (wavs[i],),
            batch_size, lattice, num_blocks=num_blocks,
            compute_dtype=compute_dtype):
        outputs[i] = est
    return outputs
