"""The training recipe's step under each checkpoint policy on the card
(counterpart of ``scripts/probe_train_remat.py``).

    python -m tdanet_tpu_torch.probes.train_remat [none full scales]
        [--batch 8] [--out record.json]

The recipe is ``configs/tdanet.yml`` (``probes/train_step.py``'s RECIPE:
TDANetBest out 128, in 512, 16 blocks, depth 5, 8 kHz, 3 s, bf16
activations over fp32 parameters, dropout and drop-path on). The
policies are ``Recurrent``'s ``remat``:

- none: autograd keeps every activation;
- full: each iteration's input; the backward recomputes the iteration;
- scales (the trainer's default): the landmarks of the JAX package's
  policy, the pyramid scales, GA's output and the fusions the expansion
  reads; the backward recomputes each stage between them once.

For each policy: the median step ms (5 steps after 2 warm-up steps, host
clock around synchronised steps), the peak allocated GiB over those
steps, #1's forward and backward launches per step (held to
``train_step.expected_launches``), and one profiled step
(``timing.profiled``): its device ms and device kernels, #1's device
kernels among them held to the launches (``timing.counted_windows``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from tdanet_tpu_torch.probes import train_step
from tdanet_tpu_torch.utils.timing import card_line

POLICIES = {"none": False, "full": True, "scales": "scales"}
# #1's sites a block iteration at depth 5: 5 pyramid stages + 5 LA fusions
# x 3 + 4 expansion LAs x 3; the coarsest fusion's 3 never reach the loss
SITES, DEAD = 32, 3


def measure(name, B=8):
    """One policy's row: step ms and runs, peak bytes and GiB, #1's
    launches a step (held exact) and the profiled step's record."""
    remat = POLICIES[name]
    blocks = train_step.RECIPE["num_blocks"]
    want = train_step.expected_launches(remat, SITES * blocks,
                                        DEAD * blocks)
    row = train_step.time_steps(B, remat, profile=True)
    got = tuple(row["launches_per_step"])
    print(f"{name}: #1 launches a step {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{name}: #1 launches {got} a step, expected "
                             f"{want}")
    return dict(row, policy=name, peak_gib=row["peak_bytes"] / 2 ** 30,
                launches_per_step=list(got))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("policies", nargs="*", default=list(POLICIES),
                    choices=list(POLICIES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this probe runs on a GPU")
    card = card_line()
    print(card)
    record = dict(card=card, rows=[measure(p, args.batch)
                                   for p in args.policies])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    sys.exit(main() and 0)
