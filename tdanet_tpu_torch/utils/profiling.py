"""Parameter and MAC counts of a model (counterpart of
``tdanet_tpu/utils/profiling.py``; the reference prints thop's MACs and
parameters at train start, audio_train.py:165-168).

:func:`count_macs` is half of the FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts over one forward: the
multiply-accumulates of the convolutions (transposed ones too), linear
layers and matrix products, one per weight element and output position.
Normalisation, activations, pooling, resampling, softmax and the other
elementwise work are not counted. The JAX package's number is XLA's cost
analysis of the compiled forward, which counts that work too, so it is the
larger of the two. The forward runs on a copy of the model on the meta
device: no data, no kernel launch, the same count on every device.
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_params(model) -> int:
    """The number of parameter elements."""
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def count_macs(model, example, **forward_kwargs) -> int:
    """MACs of ``model(example, **forward_kwargs)``, an inference forward,
    counted on a meta copy of the model (``example``'s shape and dtype
    are what matter)."""
    meta = copy.deepcopy(model).to("meta")
    x = torch.empty(example.shape, dtype=example.dtype, device="meta")
    with FlopCounterMode(display=False) as counter:
        meta(x, **forward_kwargs)
    return counter.get_total_flops() // 2


def profile_model(model, example, **forward_kwargs) -> dict:
    """dict(params, flops, macs) of one forward on ``example``."""
    macs = count_macs(model, example, **forward_kwargs)
    return {"params": count_params(model), "flops": 2 * macs, "macs": macs}
