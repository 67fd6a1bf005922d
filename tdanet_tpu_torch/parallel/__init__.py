"""Parallelism: device meshes and the data-parallel collectives
(counterpart of ``tdanet_tpu/parallel``; sequence parallelism,
``parallel/sequence.py`` there, is not ported: ROADMAP A #10)."""

from tdanet_tpu_torch.parallel.mesh import (
    TDANET_TP_RULES,
    Mesh,
    batch_sharding,
    dp_batch_setup,
    initialize_distributed,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)

__all__ = [
    "Mesh", "TDANET_TP_RULES", "batch_sharding", "dp_batch_setup",
    "initialize_distributed", "make_mesh", "param_shardings", "replicated",
    "shard_params",
]
