"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``dw_conv_glob_ln``, ``uconv_block``, ``window_process`` (exported
here as the JAX package exports its pair) and ``micro_ops``."""

from tdanet_tpu_torch.kernels.window_process import (  # noqa: F401
    WindowProcess, WindowProcessReverse, roll_and_window_partition,
    roll_and_window_partition_reference, window_merge_and_roll,
    window_merge_and_roll_reference, window_partition, window_reverse)

__all__ = [
    "WindowProcess", "WindowProcessReverse", "roll_and_window_partition",
    "roll_and_window_partition_reference", "window_merge_and_roll",
    "window_merge_and_roll_reference", "window_partition", "window_reverse",
]
