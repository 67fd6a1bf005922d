"""Plain PyTorch ops with the JAX package's numerics (see ``basic``)."""
