"""Shared helpers for the PyTorch port's tests against the JAX package.

A model is built once in JAX, its parameters are perturbed with seeded
numpy noise (unit gammas, zero betas and zero attention biases would hide
a mis-mapped key), and the same flat arrays are loaded into the port.
"""
import numpy as np

from tdanet_tpu_torch.probes import era


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


def jax_init_flat(init, seed=0, jit=True):
    """Perturbed flat f32 parameters of a JAX ``init(key)`` (a model's or
    a block's), from ``seed``. ``jit=False`` runs the init eagerly, which
    is faster for an init of many small draws that runs once."""
    import jax
    from tdanet_tpu.models import pytree_to_flat_torch
    fn = jax.jit(init) if jit else init
    flat = pytree_to_flat_torch(fn(jax.random.PRNGKey(seed)))
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


# -- the EMCAD-era family ----------------------------------------------------

ERA_T = 1000  # samples at 8 kHz; feat_len_for(1000, 4, 8000) = 134 frames
# the 22 classes of models/tdanet_emcad.py -> #1's sites a block iteration
# at depth 5: the chip probe's table (at in 512), except TDANetEMCADv1_4,
# tested at in 256, where its LGAG3 gates' groups of 256 make 14 of them
# depthwise
ERA_SITES = {**era.SITES,
             "TDANetEMCADv1_4": era.SITES["TDANetEMCADv1_4"] + 14}


def era_cfg(name, **over):
    """An era class's test config: out 64, in 128 (256 for
    TDANetEMCADv1_4), 1 block, depth 5, 4 ms at 8 kHz, feat_len for
    ERA_T samples."""
    from tdanet_tpu_torch.models import feat_len_for
    cfg = dict(out_channels=64, in_channels=128, num_blocks=1,
               upsampling_depth=5, enc_kernel_size=4, num_sources=2,
               sample_rate=8000, feat_len=feat_len_for(ERA_T, 4, 8000))
    if name == "TDANetEMCADv1_4":
        cfg["in_channels"] = 256
    return {**cfg, **over}


def jax_apply64(fn, flat, *inputs):
    """fn(params, *inputs) under jit in float64 on the flat parameters,
    as numpy."""
    import jax
    import jax.numpy as jnp
    from tdanet_tpu.models import flat_torch_to_pytree
    with jax.enable_x64():
        params = flat_torch_to_pytree(
            {k: np.asarray(v, np.float64) for k, v in flat.items()})
        out = jax.jit(fn)(params, *(jnp.asarray(a) for a in inputs))
        return jax.tree_util.tree_map(np.asarray, out)


def assert_close64(got, want, rtol=1e-10):
    """float64 agreement at ``rtol`` of the reference's largest value."""
    got = np.asarray(got)
    assert got.dtype == np.float64 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def era_pair(name, seed, **over):
    """(JAX model, perturbed flat params from its eager init, the port's
    model in float64 with those params) for an era class."""
    import tdanet_tpu.models as jzoo
    import tdanet_tpu_torch.models as tzoo
    from tdanet_tpu_torch.models import load_jax_params
    cfg = era_cfg(name, **over)
    jmodel = getattr(jzoo, name)(**cfg)
    flat = jax_init_flat(jmodel.init, seed=seed, jit=False)
    model = getattr(tzoo, name)(**cfg).double().eval()
    return jmodel, flat, load_jax_params(model, flat)


def check_era_forward(name, seed):
    """The port's class against the JAX class in float64 at B=2, T ERA_T,
    1e-10 of the largest output."""
    import jax.numpy as jnp
    import torch
    jmodel, flat, model = era_pair(name, seed)
    x = np.random.default_rng(seed).standard_normal((2, ERA_T))
    want = jax_apply64(lambda p, w: jmodel.apply(
        p, w, compute_dtype=jnp.float64), flat, x)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, ERA_T)
    assert_close64(got, want)
