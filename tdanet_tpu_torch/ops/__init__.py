"""Plain PyTorch ops with the JAX package's numerics (see ``basic``)."""

from tdanet_tpu_torch.ops.basic import (ACT_STORAGE_MODES, act_storage,
                                        act_storage_mode, store_activation)

__all__ = ["ACT_STORAGE_MODES", "act_storage", "act_storage_mode",
           "store_activation"]
