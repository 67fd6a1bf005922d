"""SI-SNRi cost of 8-bit activation storage on a trained model
(counterpart of ``scripts/probe_act_quant_quality.py``): the recurrence's
landmark tensors stored as int8, float8_e4m3fn or float8_e5m2
(``ops.act_storage``), at depth 16 in bf16, on the early-exit probe's
test set. One JSON line a mode, ``{"storage", "sisnri_db"}``, "off" first.

Usage: python -m tdanet_tpu_torch.scripts.probe_act_quant_quality
         [--ckpt PATH] [--n 100] [--batch 25] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from tdanet_tpu_torch import ops
from tdanet_tpu_torch.scripts.probe_early_exit import (
    add_common_args, device_line, load_model, make_tt, separate_at_depth,
    sisnri)


def storage_rows(model, mixes, srcs, batch, compute_dtype=torch.bfloat16,
                 depth=16):
    """``{"storage", "sisnri_db"}`` a mode (unrounded), every forward at
    ``depth`` under that mode."""
    rows = []
    for mode in ops.ACT_STORAGE_MODES:
        with ops.act_storage(mode):
            ests = separate_at_depth(model, mixes, depth, batch,
                                     compute_dtype)
        rows.append({"storage": mode or "off",
                     "sisnri_db": sisnri(ests, srcs, mixes)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    args = ap.parse_args(argv)
    model = load_model(args.ckpt, args.device)
    print(device_line(next(model.parameters()).device), file=sys.stderr)
    mixes, srcs = make_tt(args.n)
    rows = storage_rows(model, mixes, srcs, args.batch)
    for r in rows:
        print(json.dumps({"storage": r["storage"],
                          "sisnri_db": round(r["sisnri_db"], 2)}),
              flush=True)
    return rows


if __name__ == "__main__":
    main()
