"""The hybrid UConvBlock on the card: pyramid_fused, then the module's tail
(GA, LA fusion, expansion, res_conv), against the module block and the
module's pyramid half alone (counterpart of ``scripts/probe_hybrid.py``).

    python -m tdanet_tpu_torch.probes.hybrid [batch]

At the bench model's full width in bf16 with seeded weights it prints the
20-block chain's SNR against the module chain, then ms/block of the module
block, the module's pyramid half and the hybrid block, from CUDA events,
replayed from a CUDA graph and eager.
"""

from __future__ import annotations

import sys

import torch

from tdanet_tpu_torch.kernels.uconv_block import pyramid_fused
from tdanet_tpu_torch.probes.uconv_kernel import (
    C, CHAIN, COUT, DEPTH, T, setup)
from tdanet_tpu_torch.utils.timing import (
    card_line, cuda_time, graph_time, snr_db)


def hybrid_block(block, x, per_utterance=False):
    """pyramid_fused in model layout, then the module block's tail."""
    scales, pooled = pyramid_fused(x, block, depth=block.depth)
    return block.tail(x, scales, pooled, per_utterance)


def compare_chain(block, x, n=CHAIN):
    """n hybrid blocks against n module blocks: (SNR dB, max abs)."""
    got = want = x
    for _ in range(n):
        got = hybrid_block(block, got)
        want = block(want)
    return snr_db(want, got), (got.float() - want.float()).abs().max().item()


def time_blocks(block, x):
    """ms per block of the module block, its pyramid half and the hybrid
    block: {name: (graph replay ms, eager ms)}."""
    calls = {
        "module block": lambda: block(x),
        "module pyramid half": lambda: block.pyramid(x),
        "hybrid block": lambda: hybrid_block(block, x),
    }
    return {name: (graph_time(fn, reps=CHAIN)[0],
                   cuda_time(fn, reps=CHAIN)[0])
            for name, fn in calls.items()}


def main(argv):
    B = int(argv[0]) if argv else 24
    block, x = setup(B, torch.bfloat16)
    print(f"card: {card_line()}; B={B} T={T} C_out={COUT} C={C} "
          f"depth={DEPTH} bf16", flush=True)
    with torch.inference_mode():
        snr, err = compare_chain(block, x)
        print(f"hybrid chained x{CHAIN} vs the module block in bf16: max "
              f"abs err {err:.4e}, SNR {snr:.1f} dB", flush=True)
        for name, (g_ms, e_ms) in time_blocks(block, x).items():
            print(f"{name}: {g_ms:.3f} ms/block CUDA graph, {e_ms:.3f} "
                  f"ms/block eager (B={B})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
