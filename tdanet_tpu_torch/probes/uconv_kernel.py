"""The fused UConvBlock on the card: its numerics against the module block
and its time (counterpart of ``scripts/probe_uconv_kernel.py``).

    python -m tdanet_tpu_torch.probes.uconv_kernel [batch]

The fused block is pyramid_fused -> GA (plain PyTorch) -> fuse_expand_fused,
chained in the padded channels-last layout. At the bench model's full width
(T 2010, C_out 128, C 512, depth 5) in bf16 with seeded weights, the probe
chains it 20 times and compares the result with 20 module blocks (SNR and
max abs), then prints ms/block of the fused block, of pyramid_fused alone
and of the module block, from CUDA events, replayed from a CUDA graph and
eager.
"""

from __future__ import annotations

import sys

import torch

from tdanet_tpu_torch.kernels.uconv_block import (
    PAD, from_raw, fuse_expand_fused, pyramid_fused, scale_lengths, to_raw)
from tdanet_tpu_torch.models.base import init_parameters_
from tdanet_tpu_torch.models.components import UConvBlock
from tdanet_tpu_torch.utils.timing import (
    card_line, cuda_time, graph_time, snr_db)

T, COUT, C, DEPTH = 2010, 128, 512, 5
CHAIN = 20


def fused_block_raw(block, x_raw, T0, per_utterance=False):
    """One UConvBlock on the padded (B, _pads(T0), C_out) buffer -> the
    same layout, with no relayout: pyramid_fused, GA on the (B, C, T_g)
    view of the pooled rows, fuse_expand_fused."""
    Ts = scale_lengths(T0, block.depth)
    scales_raw, g_raw = pyramid_fused(x_raw, block, depth=block.depth,
                                      raw=True, raw_in=True, T0=T0)
    g = block.globalatt(g_raw[:, :Ts[-1]].transpose(1, 2), per_utterance)
    return fuse_expand_fused(scales_raw, g.transpose(1, 2), x_raw, block,
                             Ts=Ts)


def fused_block(block, x, per_utterance=False):
    """:func:`fused_block_raw` in model layout: (B, C_out, T) -> the
    same."""
    T0 = x.shape[-1]
    return from_raw(fused_block_raw(block, to_raw(x), T0, per_utterance), T0)


def seeded_block(out_channels, in_channels, depth, seed):
    """A UConvBlock with the JAX init's distributions from ``seed``, then
    seeded noise on every parameter: unit gains and zero shifts would
    hide a parameter read in the wrong place (a leaked beta above all)."""
    gen = torch.Generator().manual_seed(seed)
    block = init_parameters_(UConvBlock(out_channels, in_channels, depth),
                             gen)
    with torch.no_grad():
        for p in block.parameters():
            scale = p.abs().mean().item() or 1.0
            p.mul_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            p.add_(0.1 * scale * torch.randn(p.shape, generator=gen))
    return block.eval()


def compare_chain(block, x, n=CHAIN):
    """n fused blocks in the padded layout against n module blocks, from
    the same (B, C_out, T) input. Returns (SNR dB, max abs difference)."""
    T0 = x.shape[-1]
    h = to_raw(x)
    for _ in range(n):
        h = fused_block_raw(block, h, T0)
    got = from_raw(h, T0)
    want = x
    for _ in range(n):
        want = block(want)
    return snr_db(want, got), (got.float() - want.float()).abs().max().item()


def time_blocks(block, x):
    """ms per block of the fused block, pyramid_fused alone and the module
    block: {name: (graph replay ms, eager ms)}, CUDA events, CHAIN calls
    per run."""
    T0 = x.shape[-1]
    x_raw = to_raw(x)
    calls = {
        "fused block": lambda: fused_block_raw(block, x_raw, T0),
        "pyramid_fused alone": lambda: pyramid_fused(
            x_raw, block, depth=block.depth, raw=True, raw_in=True, T0=T0),
        "module block": lambda: block(x),
    }
    return {name: (graph_time(fn, reps=CHAIN)[0],
                   cuda_time(fn, reps=CHAIN)[0])
            for name, fn in calls.items()}


def setup(B, dtype, seed=0):
    """(block on the card, (B, C_out, T) input) at the bench shape; TF32
    off."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    block = seeded_block(COUT, C, DEPTH, seed).cuda()
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(B, COUT, T, generator=gen).to(dtype).cuda()
    return block, x


def main(argv):
    B = int(argv[0]) if argv else 24
    block, x = setup(B, torch.bfloat16)
    print(f"card: {card_line()}; B={B} T={T} C_out={COUT} C={C} "
          f"depth={DEPTH} bf16 (PAD {PAD})", flush=True)
    with torch.inference_mode():
        snr, err = compare_chain(block, x)
        print(f"chained x{CHAIN}: max abs err {err:.4e}, SNR vs the module "
              f"block in bf16 {snr:.1f} dB", flush=True)
        for name, (g_ms, e_ms) in time_blocks(block, x).items():
            print(f"{name}: {g_ms:.3f} ms/block CUDA graph, {e_ms:.3f} "
                  f"ms/block eager (B={B})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
