"""The port's Swin modules and models against ``tdanet_tpu.models.swin`` in
float64 (JAX under ``jax.enable_x64()``): the same seeded numpy inputs and
the JAX init's parameters, flattened with ``pytree_to_flat_torch`` and
loaded with ``load_jax_params``. Outputs agree at 1e-10, the Swin-UNet's
parameter gradients at 1e-9 (relative to the largest value).
"""
import numpy as np
import pytest
import torch

from tdanet_tpu_torch.models import load_jax_params
from tdanet_tpu_torch.models import swin as ts
from tdanet_tpu_torch.ops import basic as tops

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from tdanet_tpu.models import pytree_to_flat_torch  # noqa: E402
from tdanet_tpu.models import swin as js  # noqa: E402
from tdanet_tpu.models.base import flat_torch_to_pytree  # noqa: E402

from torch_port_helpers import perturb_flat  # noqa: E402

OUT_TOL, GRAD_TOL = 1e-10, 1e-9


def _pair(name, *args, seed=0, **kw):
    """(JAX module, its perturbed float64 params as a pytree, the port's
    module in float64 with the same params loaded, the flat params)."""
    j = getattr(js, name)(*args, **kw)
    flat = perturb_flat(pytree_to_flat_torch(j.init(
        jax.random.PRNGKey(seed))), seed)
    flat = {k: v.astype(np.float64) for k, v in flat.items()}
    t = getattr(ts, name)(*args, **kw).double().eval()
    load_jax_params(t, flat)
    with jax.enable_x64():
        params = flat_torch_to_pytree(flat)
    return j, params, t, flat


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, want, tol=OUT_TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _apply(j, params, *xs):
    """The JAX module's output; jitted, which on the CPU costs less than
    dispatching a whole model op by op."""
    with jax.enable_x64():
        return np.asarray(jax.jit(j.apply)(
            params, *[jnp.asarray(x) for x in xs]))


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention(masked):
    j, params, t, _ = _pair("WindowAttention", 24, (4, 4), 3)
    x = _x((6, 16, 24), 1)
    mask = None
    if masked:
        mask = np.asarray(js._attn_mask(8, 12, 4, 2))  # (6, 16, 16)
        np.testing.assert_array_equal(mask, ts._attn_mask(8, 12, 4, 2))
    with jax.enable_x64():
        want = np.asarray(j.apply(params, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask)))
    got = t(torch.from_numpy(x),
            None if mask is None else torch.tensor(mask))
    _close(got, want)


def test_relative_position_index_equals_jax():
    np.testing.assert_array_equal(ts.relative_position_index(3, 5),
                                  js.relative_position_index(3, 5))


@pytest.mark.parametrize("shift,mlp_conv", [(0, False), (2, False),
                                            (0, True), (2, True)])
def test_swin_transformer_block(shift, mlp_conv):
    j, params, t, _ = _pair("SwinTransformerBlock", 16, (8, 12), 2,
                            window_size=4, shift_size=shift,
                            mlp_conv=mlp_conv)
    assert (t.attn_mask is not None) == (shift > 0)
    x = _x((2, 96, 16), 2)
    _close(t(torch.from_numpy(x)), _apply(j, params, x))


def test_block_at_window_resolution_has_one_window_and_no_shift():
    t = ts.SwinTransformerBlock(8, (4, 4), 2, window_size=7, shift_size=3)
    assert (t.window_size, t.shift_size, t.attn_mask) == (4, 0, None)


@pytest.mark.parametrize("name,args,kw,shape", [
    ("PatchMerging", ((8, 6), 10), {}, (2, 48, 10)),
    ("PatchExpand", ((4, 6), 16), {}, (2, 24, 16)),
    ("PatchExpand", ((4, 6), 16), {"dim_scale": 4}, (2, 24, 16)),
    ("FinalPatchExpand_X4", ((4, 6), 8), {}, (2, 24, 8)),
    ("FinalPatchExpand_X4", ((4, 6), 8), {"dim_scale": 2}, (2, 24, 8)),
    ("FinalPatchExpandX4Custom", ((4, 6), 8), {"dim_scale": (2, 3)},
     (2, 24, 8)),
    ("PatchEmbed", (), {"img_size": (8, 12), "patch_size": (2, 3),
                        "in_chans": 5, "embed_dim": 12}, (2, 5, 8, 12)),
    ("PatchEmbed", (), {"img_size": 8, "patch_size": 2, "in_chans": 3,
                        "embed_dim": 6, "norm": False}, (2, 3, 8, 8)),
    ("Mlp", (12, 20), {}, (2, 7, 12)),
    ("MlpConv", (12, 20), {}, (2, 7, 12)),
])
def test_module(name, args, kw, shape):
    j, params, t, flat = _pair(name, *args, **kw)
    assert set(t.state_dict()) == set(flat)
    x = _x(shape, 3)
    _close(t(torch.from_numpy(x)), _apply(j, params, x))


# the small configurations of tests/test_swin.py
CLASSIFIER = dict(img_size=16, patch_size=2, in_chans=8, num_classes=10,
                  embed_dim=24, depths=[2, 2], num_heads=[3, 6],
                  window_size=2, drop_path_rate=0.1)
SHIFTED = dict(img_size=32, patch_size=2, in_chans=4, num_classes=5,
               embed_dim=16, depths=[2], num_heads=[2], window_size=4)
UNET = dict(img_size=16, patch_size=2, in_chans=12, num_classes=12,
            embed_dim=8, depths=[1, 1, 1, 1], depths_decoder=[1, 1, 1, 1],
            num_heads=[1, 2, 4, 8], window_size=2, dim_scale=2)
UNET_SHIFTED = dict(img_size=32, patch_size=2, in_chans=4, num_classes=3,
                    embed_dim=8, depths=[2, 2], num_heads=[2, 2],
                    window_size=4, dim_scale=2)
CUSTOM = dict(img_size=(16, 16), patch_size=(2, 2), in_chans=3,
              num_classes=5, embed_dim=8, depths=[1, 1, 1, 1],
              depths_decoder=[1, 1, 1, 1], num_heads=[1, 2, 4, 8],
              window_size=2)
CUSTOM_RECT = dict(img_size=(16, 32), patch_size=(2, 4), in_chans=3,
                   num_classes=4, embed_dim=8, depths=[2, 1],
                   num_heads=[2, 4], window_size=4, ape=True)


@pytest.mark.parametrize("name,kw,shape", [
    ("SwinTransformer", CLASSIFIER, (2, 8, 16, 16)),
    ("SwinTransformer", SHIFTED, (2, 4, 32, 32)),
    ("SwinTransformer", {**SHIFTED, "ape": True, "num_classes": 0},
     (2, 4, 32, 32)),
    ("SwinTransformerSys", UNET, (2, 12, 256)),
    ("SwinTransformerSys", UNET_SHIFTED, (2, 4, 1024)),
    ("SwinTransformerSysCustom", CUSTOM, (2, 3, 16, 16)),
    ("SwinTransformerSysCustom", CUSTOM_RECT, (2, 3, 16, 32)),
])
def test_model_matches_jax(name, kw, shape):
    j, params, t, flat = _pair(name, **kw)
    assert set(t.state_dict()) == set(flat)
    assert not any(k.endswith(("relative_position_index", "attn_mask"))
                   for k in t.state_dict())
    x = _x(shape, 4)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    _close(got, _apply(j, params, x))


@pytest.mark.parametrize("kw,shape", [(UNET, (2, 12, 256)),
                                      (UNET_SHIFTED, (2, 4, 1024))])
def test_swin_unet_gradients_match_jax_grad(kw, shape):
    """Every parameter's gradient of a mean-of-squares loss, through the
    window Functions' backward, against jax.grad."""
    j, params, t, flat = _pair("SwinTransformerSys", **kw)
    x = _x(shape, 5)
    with jax.enable_x64():
        grads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
            j.apply(p, jnp.asarray(x))))))(params)
        want = pytree_to_flat_torch(grads)
    t(torch.from_numpy(x)).square().mean().backward()
    got = {k: p.grad for k, p in t.named_parameters()}
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k] is not None, k
        _close(got[k], want[k], GRAD_TOL)


def test_load_jax_params_rejects_a_missing_or_extra_key():
    _, _, t, flat = _pair("SwinTransformerSys", **UNET)
    some = sorted(flat)[0]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(t, {k: v for k, v in flat.items() if k != some})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_params(t, {**flat, "layers.0.blocks.0.not_a_parameter":
                            np.zeros(3)})


def test_state_dict_with_buffers_loads_strictly():
    """A Swin state dict that carries its deterministic buffers (relative
    position index, shifted-window mask), as a torch Swin module with
    persistent buffers writes it, loads with strict=True: the port
    recomputes them, as the JAX bridge does."""
    _, _, t, flat = _pair("SwinTransformerSys", **UNET_SHIFTED)
    buffers = {f"{name}.relative_position_index": np.zeros((16, 16), np.int64)
               for name, m in t.named_modules()
               if hasattr(m, "relative_position_index")}
    buffers.update({f"{name}.attn_mask": np.zeros((4, 16, 16))
                    for name, m in t.named_modules()
                    if getattr(m, "attn_mask", None) is not None})
    assert any(k.endswith("attn_mask") for k in buffers)
    assert any(k.endswith("relative_position_index") for k in buffers)
    fresh = ts.SwinTransformerSys(**UNET_SHIFTED).double()
    load_jax_params(fresh, {**flat, **buffers})
    for k, v in t.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for name, m in fresh.named_modules():
        if getattr(m, "attn_mask", None) is not None:
            assert m.attn_mask.abs().max() > 0  # recomputed, not loaded


def test_unknown_kwargs_warn():
    with pytest.warns(UserWarning, match="ignoring unknown kwargs"):
        ts.SwinTransformerSys(**UNET, not_an_option=1)


def test_reset_parameters_follows_the_jax_init():
    t = ts.SwinTransformerSys(**{**UNET, "ape": True, "embed_dim": 32,
                                 "num_heads": [2, 2, 4, 8]})
    t.reset_parameters(torch.Generator().manual_seed(0))
    sd = t.state_dict()
    w = sd["layers.0.blocks.0.attn.qkv.weight"]
    assert w.abs().max() <= 0.04 + 1e-7 and 0.01 < w.std() < 0.025
    assert sd["layers.0.blocks.0.attn.qkv.bias"].abs().max() == 0
    assert sd["absolute_pos_embed"].abs().max() > 0
    table = sd["layers.0.blocks.0.attn.relative_position_bias_table"]
    assert 0 < table.abs().max() <= 0.04 + 1e-7
    assert torch.equal(sd["norm.weight"], torch.ones(256))
    assert torch.equal(sd["layers.0.blocks.0.mlp.fc1.norm.weight"],
                       torch.ones(128))
    pw = sd["patch_embed.proj.weight"]
    assert pw.abs().max() <= 1 / np.sqrt(12 * 4) and pw.std() > 0.05
    assert sd["patch_embed.proj.bias"].abs().max() == 0
    assert sd["output.weight"].abs().max() <= 1 / np.sqrt(32)
    again = ts.SwinTransformerSys(**{**UNET, "ape": True, "embed_dim": 32,
                                     "num_heads": [2, 2, 4, 8]})
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


# ---------------------------------------------------------------------------
# dropout and drop-path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [tops.dropout, tops.drop_path])
def test_noise_is_identity_at_rate_0_or_when_not_training(fn):
    x = torch.from_numpy(_x((4, 5, 6), 6))
    gen = torch.Generator().manual_seed(0)
    assert fn(x, gen, 0.0, True) is x
    assert fn(x, gen, 0.5, False) is x
    assert fn(x, None, 0.5, False) is x
    with pytest.raises(ValueError, match="torch.Generator"):
        fn(x, None, 0.5, True)


def test_dropout_keeps_the_share_and_scales():
    x = torch.ones(200, 500, dtype=torch.float64)
    y = tops.dropout(x, torch.Generator().manual_seed(1), 0.25, True)
    kept = y != 0
    assert abs(kept.double().mean().item() - 0.75) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = tops.dropout(x, torch.Generator().manual_seed(1), 0.25, True)
    assert torch.equal(y, again)


def test_drop_path_drops_whole_samples_and_scales():
    x = torch.ones(4000, 3, 2)
    y = tops.drop_path(x, torch.Generator().manual_seed(2), 0.2, True)
    per_sample = y.reshape(4000, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.8).all(1)).all()
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.8) < 0.02


def test_training_forward_draws_from_the_generator():
    t = ts.SwinTransformerSys(**{**UNET, "drop_rate": 0.1,
                                 "attn_drop_rate": 0.1,
                                 "drop_path_rate": 0.2}).double()
    t.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.from_numpy(_x((2, 12, 256), 7))
    t.train()
    a = t(x, torch.Generator().manual_seed(4))
    b = t(x, torch.Generator().manual_seed(4))
    c = t(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        t(x)
    t.eval()
    assert torch.equal(t(x), t(x))
