"""High-level separation helpers (counterpart of
``tdanet_tpu/utils/separator.py``): pad to the model's stride lattice,
separate on the model's device, trim, and renormalise each utterance's
output energy to its mixture's over the true region."""

from __future__ import annotations

import numpy as np
import torch


def _device_dtype(model):
    p = next(model.parameters())
    return p.device, p.dtype


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
        out = model(xp, num_blocks=num_blocks)[..., :T]
        # per-utterance energy renormalisation over the true region
        scale = x.abs().sum(-1)[:, None, None] / (
            out.abs().sum((-1, -2))[:, None, None] + 1e-8)
        out = out * scale
    if was_1d:
        out = out[0]
    if is_numpy:  # numpy has no bf16: upcast it, keep f32 and f64
        return out.to(torch.promote_types(out.dtype, torch.float32)).cpu() \
            .numpy()
    return out


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


def separate_batched(model, wavs, batch_size=8, lattice=None,
                     num_blocks=None):
    """Separate variable-length utterances in lattice-length buckets,
    ``batch_size`` at a time. Every row is separated as if alone (the
    per-utterance attention collapse), so results do not depend on which
    utterances share a batch. Returns numpy (n_src, T_i) estimates in input
    order, in the model's dtype (bf16 upcast to float32, as in
    :func:`separate`)."""
    device, dtype = _device_dtype(model)
    lattice = lattice or getattr(model, "lcm", 1)
    wavs = [np.asarray(w, np.float32) for w in wavs]
    outputs = [None] * len(wavs)
    plan = plan_lattice_buckets([w.shape[-1] for w in wavs], lattice,
                                batch_size)
    with torch.inference_mode():
        for target, chunk in plan:
            batch = np.zeros((len(chunk), target), np.float32)
            for row, i in enumerate(chunk):
                batch[row, :wavs[i].shape[-1]] = wavs[i]
            xb = torch.from_numpy(batch).to(device=device, dtype=dtype)
            est = model(xb, num_blocks=num_blocks, per_utterance=True)
            est = est.to(torch.promote_types(est.dtype, torch.float32)) \
                .cpu().numpy()
            for row, i in enumerate(chunk):
                outputs[i] = trim_renorm(wavs[i], est[row])
    return outputs
