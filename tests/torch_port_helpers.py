"""Shared helpers for the PyTorch port's tests against the JAX package.

A model is built once in JAX, its parameters are perturbed with seeded
numpy noise (unit gammas, zero betas and zero attention biases would hide
a mis-mapped key), and the same flat arrays are loaded into the port.
"""
import numpy as np


def perturb_flat(flat, seed=0, scale=0.1):
    """Every leaf gets multiplicative and additive seeded noise."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        v = np.asarray(flat[k], np.float64)
        mult = 1.0 + scale * rng.standard_normal(v.shape)
        add = scale * np.abs(v).mean() * rng.standard_normal(v.shape) \
            if np.abs(v).mean() > 0 else scale * rng.standard_normal(v.shape)
        out[k] = (v * mult + add).astype(np.float32)
    return out


def jax_init_flat(init, seed=0):
    """Perturbed flat f32 parameters of a JAX ``init(key)`` (a model's or
    a block's), from ``seed``."""
    import jax
    from tdanet_tpu.models import pytree_to_flat_torch
    flat = pytree_to_flat_torch(jax.jit(init)(jax.random.PRNGKey(seed)))
    return perturb_flat(flat, seed)


def jax_tdanet_best(cfg, seed=0):
    """(JAX model, perturbed flat f32 params) for a TDANetBest config."""
    import jax
    from tdanet_tpu.models import TDANetBest, pytree_to_flat_torch
    jmodel = TDANetBest(**cfg)
    # jit: the same params as the eager init, compiled in less time
    flat = pytree_to_flat_torch(jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed)))
    return jmodel, perturb_flat(flat, seed)


def port_tdanet_best(cfg, flat, dtype):
    from tdanet_tpu_torch.models import TDANetBest, load_jax_params
    model = TDANetBest(**cfg).to(dtype).eval()
    return load_jax_params(model, flat)
