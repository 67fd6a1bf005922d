"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``dw_conv_glob_ln``)."""
