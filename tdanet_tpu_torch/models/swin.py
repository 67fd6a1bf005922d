"""Swin Transformer (2-D) and Swin-UNet as ``nn.Module``s (counterpart of
``tdanet_tpu/models/swin.py``), forward and backward.

Class names and parameter names follow the JAX package's parameter tree,
so a model's ``state_dict()`` keys equal its flat JAX keys. The window
shift + partition and merge + shift go through the CUDA kernel pair of
``tdanet_tpu_torch.kernels.window_process`` on the card, in both
directions. The relative-position index and the shifted-window mask are
non-persistent buffers: they are recomputed, never stored in a checkpoint.

Training-time dropout and drop-path draw from the ``generator`` passed to
``forward``; with every rate at 0, or in ``eval()``, none is needed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tdanet_tpu_torch.kernels.window_process import (
    roll_and_window_partition, window_merge_and_roll)
from tdanet_tpu_torch.models.base import warn_unused_kwargs
from tdanet_tpu_torch.models.components import ConvNorm, GroupNorm1
from tdanet_tpu_torch.ops import basic as ops


def _linear(x, lin):
    return F.linear(x, lin.weight.to(x.dtype),
                    None if lin.bias is None else lin.bias.to(x.dtype))


def _norm(x, ln):
    return ops.layer_norm(x, ln.weight, ln.bias)


def _to2(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, in_features, hidden_features=None, out_features=None,
                 drop=0.0):
        super().__init__()
        hidden = hidden_features or in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, out_features or in_features)
        self.drop = drop

    def forward(self, x, generator=None):
        x = ops.gelu(_linear(x, self.fc1))
        x = ops.dropout(x, generator, self.drop, self.training)
        x = _linear(x, self.fc2)
        return ops.dropout(x, generator, self.drop, self.training)


class MlpConv(nn.Module):
    """The Swin-UNet blocks' conv-flavoured MLP: ConvNorm 1x1 -> depthwise
    k5 -> GELU -> ConvNorm 1x1 (GroupNorm(1, C) norms), over the transposed
    (B, C, N) layout."""

    def __init__(self, in_features, hidden_features, drop=0.0):
        super().__init__()
        self.fc1 = ConvNorm(in_features, hidden_features, 1, bias=False,
                            norm="gn")
        self.dwconv = nn.Conv1d(hidden_features, hidden_features, 5,
                                padding=2, groups=hidden_features)
        self.fc2 = ConvNorm(hidden_features, in_features, 1, bias=False,
                            norm="gn")
        self.drop = drop

    def forward(self, x, generator=None):
        x = self.fc1(x.transpose(1, 2))
        x = ops.conv1d(x, self.dwconv.weight, self.dwconv.bias, padding=2,
                       groups=self.dwconv.groups)
        x = ops.dropout(ops.gelu(x), generator, self.drop, self.training)
        x = ops.dropout(self.fc2(x), generator, self.drop, self.training)
        return x.transpose(1, 2)


def relative_position_index(ws_h, ws_w):
    """(Wh*Ww, Wh*Ww) index into the bias table, as numpy."""
    coords = np.stack(np.meshgrid(np.arange(ws_h), np.arange(ws_w),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws_h - 1
    rel[:, :, 1] += ws_w - 1
    rel[:, :, 0] *= 2 * ws_w - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    """W-MSA with a relative position bias. The two products and the softmax
    are written out: scale on q, bias gather, mask add, softmax in the
    accumulation dtype, cast back."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True,
                 qk_scale=None, attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)  # (Wh, Ww)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        table = (2 * window_size[0] - 1) * (2 * window_size[1] - 1)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table, num_heads))
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(*window_size)),
            persistent=False)

    def forward(self, x, mask=None, generator=None):
        B_, N, C = x.shape
        H = self.num_heads
        acc = ops.acc_dtype(x.dtype)
        qkv = _linear(x, self.qkv).reshape(B_, N, 3, H, C // H) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul((q * self.scale).to(acc),
                            k.to(acc).transpose(-2, -1))
        bias = self.relative_position_bias_table.to(attn.dtype)[
            self.relative_position_index.reshape(-1)] \
            .reshape(N, N, -1).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, H, N, N) \
                + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(-1, H, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        attn = ops.dropout(attn, generator, self.attn_drop, self.training)
        out = torch.matmul(attn.to(acc), v.to(acc)).to(x.dtype)
        out = _linear(out.transpose(1, 2).reshape(B_, N, C), self.proj)
        return ops.dropout(out, generator, self.proj_drop, self.training)


def _attn_mask(H, W, window_size, shift_size):
    """The shifted-window mask (nW, N, N): -100 between tokens of different
    image regions, 0 elsewhere; float32."""
    img = np.zeros((H, W))
    cnt = 0
    for h in (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None)):
        for w in (slice(0, -window_size), slice(-window_size, -shift_size),
                  slice(-shift_size, None)):
            img[h, w] = cnt
            cnt += 1
    nH, nW = H // window_size, W // window_size
    wins = img.reshape(nH, window_size, nW, window_size) \
        .transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0)
                            .astype(np.float32))


class SwinTransformerBlock(nn.Module):
    """LayerNorm -> (shifted) window attention -> residual, LayerNorm ->
    MLP -> residual. A resolution no larger than the window forces one
    window and no shift."""

    def __init__(self, dim, input_resolution, num_heads, window_size=7,
                 shift_size=0, mlp_ratio=4.0, qkv_bias=True, qk_scale=None,
                 drop=0.0, attn_drop=0.0, drop_path=0.0, mlp_conv=False):
        super().__init__()
        self.dim = dim
        self.input_resolution = tuple(input_resolution)
        if min(input_resolution) <= window_size:
            shift_size = 0
            window_size = min(input_resolution)
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift_size {shift_size} must be in "
                             f"[0, {window_size})")
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, (window_size, window_size),
                                    num_heads, qkv_bias, qk_scale,
                                    attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = (MlpConv(dim, hidden, drop=drop) if mlp_conv
                    else Mlp(dim, hidden, drop=drop))
        self.drop_path = float(drop_path)
        H, W = self.input_resolution
        self.register_buffer(
            "attn_mask",
            _attn_mask(H, W, window_size, shift_size) if shift_size > 0
            else None, persistent=False)

    def forward(self, x, generator=None):
        H, W = self.input_resolution
        B, L, C = x.shape
        ws = self.window_size
        shortcut = x
        x = _norm(x, self.norm1).reshape(B, H, W, C)
        x_windows = roll_and_window_partition(x, self.shift_size, ws)
        attn_windows = self.attn(x_windows.reshape(-1, ws * ws, C),
                                 self.attn_mask, generator)
        x = window_merge_and_roll(attn_windows.reshape(-1, ws, ws, C),
                                  self.shift_size, ws, H, W)
        x = shortcut + ops.drop_path(x.reshape(B, H * W, C), generator,
                                     self.drop_path, self.training)
        y = self.mlp(_norm(x, self.norm2), generator)
        return x + ops.drop_path(y, generator, self.drop_path, self.training)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated on C, LayerNorm, Linear 4C -> 2C."""

    def __init__(self, input_resolution, dim):
        super().__init__()
        self.input_resolution, self.dim = tuple(input_resolution), dim
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        x = _norm(x.reshape(B, -1, 4 * C), self.norm)
        return _linear(x, self.reduction)


def _expand(x, H, W, p1, p2):
    """(B, H*W, p1*p2*c) -> (B, p1*H*p2*W, c): each token becomes a p1 x p2
    patch of tokens."""
    B, L, C = x.shape
    c = C // (p1 * p2)
    return x.reshape(B, H, W, p1, p2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(B, p1 * H * p2 * W, c)


class PatchExpand(nn.Module):
    """Linear C -> 2C (at dim_scale 2), 2x2 expansion to C/2, LayerNorm."""

    def __init__(self, input_resolution, dim, dim_scale=2):
        super().__init__()
        self.input_resolution, self.dim = tuple(input_resolution), dim
        self.dim_scale = dim_scale
        self.norm = nn.LayerNorm(dim // dim_scale)
        if dim_scale == 2:
            self.expand = nn.Linear(dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = self.input_resolution
        if self.dim_scale == 2:
            x = _linear(x, self.expand)
        return _norm(_expand(x, H, W, 2, 2), self.norm)


class FinalPatchExpand_X4(nn.Module):
    """Linear C -> s*s*C, s x s expansion, LayerNorm."""

    def __init__(self, input_resolution, dim, dim_scale=4):
        super().__init__()
        self.input_resolution, self.dim = tuple(input_resolution), dim
        self.dim_scale = dim_scale
        self.expand = nn.Linear(dim, dim_scale ** 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        H, W = self.input_resolution
        s = self.dim_scale
        return _norm(_expand(_linear(x, self.expand), H, W, s, s), self.norm)


class BasicLayer(nn.Module):
    """A stage of blocks, alternating shift 0 and window_size // 2, and an
    optional PatchMerging downsample."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop=0.0,
                 attn_drop=0.0, drop_path=0.0, downsample=False,
                 mlp_conv=False):
        super().__init__()
        dpr = drop_path if isinstance(drop_path, (list, tuple)) \
            else [drop_path] * depth
        self.blocks = nn.ModuleList([SwinTransformerBlock(
            dim, input_resolution, num_heads, window_size,
            0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
            qk_scale, drop, attn_drop, dpr[i], mlp_conv=mlp_conv)
            for i in range(depth)])
        if downsample:
            self.downsample = PatchMerging(input_resolution, dim)

    def forward(self, x, generator=None):
        for block in self.blocks:
            x = block(x, generator)
        if hasattr(self, "downsample"):
            x = self.downsample(x)
        return x


class BasicLayerUp(BasicLayer):
    """A decoder stage with an optional PatchExpand upsample."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop=0.0,
                 attn_drop=0.0, drop_path=0.0, upsample=False,
                 mlp_conv=True):
        super().__init__(dim, input_resolution, depth, num_heads,
                         window_size, mlp_ratio, qkv_bias, qk_scale, drop,
                         attn_drop, drop_path, downsample=False,
                         mlp_conv=mlp_conv)
        if upsample:
            self.upsample = PatchExpand(input_resolution, dim)

    def forward(self, x, generator=None):
        x = super().forward(x, generator)
        if hasattr(self, "upsample"):
            x = self.upsample(x)
        return x


class PatchEmbed(nn.Module):
    """Conv patchify: (B, C, H, W) -> (B, H/p * W/p, embed_dim) tokens."""

    def __init__(self, img_size=224, patch_size=4, in_chans=3, embed_dim=96,
                 norm=True):
        super().__init__()
        self.img_size, self.patch_size = _to2(img_size), _to2(patch_size)
        self.patches_resolution = [self.img_size[0] // self.patch_size[0],
                                   self.img_size[1] // self.patch_size[1]]
        self.num_patches = (self.patches_resolution[0]
                            * self.patches_resolution[1])
        self.in_chans, self.embed_dim = in_chans, embed_dim
        self.proj = nn.Conv2d(in_chans, embed_dim, self.patch_size,
                              stride=self.patch_size)
        if norm:
            self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        proj = self.proj
        out = F.conv2d(x, proj.weight.to(x.dtype), proj.bias.to(x.dtype),
                       stride=self.patch_size)
        out = out.flatten(2).transpose(1, 2)
        if hasattr(self, "norm"):
            out = _norm(out, self.norm)
        return out


@torch.no_grad()
def _swin_init_(model: nn.Module, generator: torch.Generator):
    """The JAX package's Swin init: truncated normal (std 0.02) linears,
    bias tables and position embeddings, zero biases, unit norms; uniform
    +-1/sqrt(fan_in) conv weights (torch's default for MlpConv's Conv1ds,
    bias included; zero bias for the patch embedding)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            ops.trunc_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, WindowAttention):
            ops.trunc_normal_(m.relative_position_bias_table, generator)
        elif isinstance(m, nn.Conv1d):
            ops.conv1d_init_(m, generator)
        elif isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, GroupNorm1)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    if getattr(model, "absolute_pos_embed", None) is not None:
        ops.trunc_normal_(model.absolute_pos_embed, generator)
    return model


def _stages(embed_dim, grid, depths, num_heads, window_size, mlp_ratio,
            qkv_bias, qk_scale, drop_rate, attn_drop_rate, dpr, mlp_conv):
    """The encoder: one BasicLayer per depth, each but the last ending in a
    PatchMerging."""
    n = len(depths)
    return nn.ModuleList([BasicLayer(
        int(embed_dim * 2 ** i), (grid[0] // 2 ** i, grid[1] // 2 ** i),
        depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias, qk_scale,
        drop_rate, attn_drop_rate, dpr[sum(depths[:i]):sum(depths[:i + 1])],
        downsample=i < n - 1, mlp_conv=mlp_conv) for i in range(n)])


class SwinTransformer(nn.Module):
    """The image classifier: (B, C, H, W) -> (B, num_classes)."""

    def __init__(self, img_size=224, patch_size=4, in_chans=3,
                 num_classes=1000, embed_dim=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
                 qkv_bias=True, qk_scale=None, drop_rate=0.0,
                 attn_drop_rate=0.0, drop_path_rate=0.1, ape=False,
                 patch_norm=True, **unused):
        super().__init__()
        warn_unused_kwargs(type(self).__name__, unused)
        self.num_layers = len(depths)
        self.embed_dim, self.num_classes = embed_dim, num_classes
        self.num_features = int(embed_dim * 2 ** (self.num_layers - 1))
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, norm=patch_norm)
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(
                1, self.patch_embed.num_patches, embed_dim))
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = _stages(
            embed_dim, self.patch_embed.patches_resolution, depths,
            num_heads, window_size, mlp_ratio, qkv_bias, qk_scale, drop_rate,
            attn_drop_rate, dpr, mlp_conv=False)
        self.norm = nn.LayerNorm(self.num_features)
        if num_classes > 0:
            self.head = nn.Linear(self.num_features, num_classes)

    def reset_parameters(self, generator: torch.Generator):
        return _swin_init_(self, generator)

    def forward(self, x, generator=None):
        x = self.patch_embed(x)
        if hasattr(self, "absolute_pos_embed"):
            x = x + self.absolute_pos_embed.to(x.dtype)
        for layer in self.layers:
            x = layer(x, generator)
        x = _norm(x, self.norm).mean(dim=1)
        if hasattr(self, "head"):
            x = _linear(x, self.head)
        return x


class SwinTransformerSys(nn.Module):
    """Swin-UNet: an encoder of BasicLayers, a decoder of BasicLayerUps with
    skip connections, and a 4x final expansion. ``forward`` takes (B, L, C)
    tokens with C a square and reads them as L-channel sqrt(C) x sqrt(C)
    images; it returns (B, num_classes, H*W). ``depths_decoder`` is
    accepted and unused: the decoder mirrors ``depths``."""

    def __init__(self, img_size=224, patch_size=4, in_chans=3,
                 num_classes=1000, embed_dim=96, depths=(2, 2, 2, 2),
                 depths_decoder=(1, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, qkv_bias=True, qk_scale=None,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.1,
                 ape=False, patch_norm=True, final_upsample="expand_first",
                 dim_scale=4, **unused):
        super().__init__()
        warn_unused_kwargs(type(self).__name__, unused)
        n = self.num_layers = len(depths)
        self.embed_dim, self.num_classes = embed_dim, num_classes
        self.dim_scale, self.final_upsample = dim_scale, final_upsample
        self.num_features = int(embed_dim * 2 ** (n - 1))
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, norm=patch_norm)
        grid = self.patches_resolution = \
            self.patch_embed.patches_resolution
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(
                1, self.patch_embed.num_patches, embed_dim))
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.layers = _stages(
            embed_dim, grid, depths, num_heads, window_size, mlp_ratio,
            qkv_bias, qk_scale, drop_rate, attn_drop_rate, dpr,
            mlp_conv=True)
        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleDict()
        for i in range(n):
            lvl = n - 1 - i
            dim = int(embed_dim * 2 ** lvl)
            res = (grid[0] // 2 ** lvl, grid[1] // 2 ** lvl)
            if i == 0:
                self.layers_up.append(PatchExpand(res, dim, 2))
                continue
            self.concat_back_dim[str(i)] = nn.Linear(2 * dim, dim)
            self.layers_up.append(BasicLayerUp(
                dim, res, depths[lvl], num_heads[lvl], window_size,
                mlp_ratio, qkv_bias, qk_scale, drop_rate, attn_drop_rate,
                dpr[sum(depths[:lvl]):sum(depths[:lvl + 1])],
                upsample=i < n - 1))
        self.norm = nn.LayerNorm(self.num_features)
        self.norm_up = nn.LayerNorm(embed_dim)
        if final_upsample == "expand_first":
            self.up = self._final_expand()
            self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def _final_expand(self):
        return FinalPatchExpand_X4(tuple(self.patches_resolution),
                                   self.embed_dim, self.dim_scale)

    def _final_scale(self):
        return self.dim_scale, self.dim_scale

    def reset_parameters(self, generator: torch.Generator):
        return _swin_init_(self, generator)

    def _features(self, x, generator):
        """(B, in_chans, H, W) image -> (B, num_classes, p1*H', p2*W')."""
        B = x.shape[0]
        x = self.patch_embed(x)
        if hasattr(self, "absolute_pos_embed"):
            x = x + self.absolute_pos_embed.to(x.dtype)
        downs = []
        for layer in self.layers:
            downs.append(x)
            x = layer(x, generator)
        x = _norm(x, self.norm)
        for i, layer_up in enumerate(self.layers_up):
            if i == 0:
                x = layer_up(x)
            else:
                x = torch.cat([x, downs[self.num_layers - 1 - i]], -1)
                x = _linear(x, self.concat_back_dim[str(i)])
                x = layer_up(x, generator)
        x = _norm(x, self.norm_up)
        if self.final_upsample == "expand_first":
            H, W = self.patches_resolution
            p1, p2 = self._final_scale()
            x = self.up(x).reshape(B, p1 * H, p2 * W, -1).permute(0, 3, 1, 2)
            x = F.conv2d(x, self.output.weight.to(x.dtype))
        return x

    def forward(self, x, generator=None):
        B, L, C = x.shape
        side = int(math.sqrt(C))
        x = self._features(x.reshape(B, L, side, side), generator)
        return x.reshape(B, self.num_classes, -1)


class FinalPatchExpandX4Custom(nn.Module):
    """The final expansion with a scale per axis: Linear C -> p1*p2*C,
    p1 x p2 expansion, LayerNorm."""

    def __init__(self, input_resolution, dim, dim_scale=(2, 2)):
        super().__init__()
        self.input_resolution, self.dim = tuple(input_resolution), dim
        self.dim_scale = tuple(dim_scale)
        p1, p2 = self.dim_scale
        self.expand = nn.Linear(dim, p1 * p2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        H, W = self.input_resolution
        p1, p2 = self.dim_scale
        return _norm(_expand(_linear(x, self.expand), H, W, p1, p2),
                     self.norm)


class SwinTransformerSysCustom(SwinTransformerSys):
    """Swin-UNet over (B, C, H, W) images with image and patch sizes per
    axis; the final expansion's scale is the patch size. Returns
    (B, num_classes, H, W)."""

    def __init__(self, img_size=(224, 224), patch_size=(4, 4), **kwargs):
        self.patch_size = _to2(patch_size)
        super().__init__(img_size=_to2(img_size), patch_size=self.patch_size,
                         **kwargs)

    def _final_expand(self):
        return FinalPatchExpandX4Custom(tuple(self.patches_resolution),
                                        self.embed_dim, self.patch_size)

    def _final_scale(self):
        return self.patch_size

    def forward(self, x, generator=None):
        return self._features(x, generator)
