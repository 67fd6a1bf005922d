"""Separate a wav with a reference-format checkpoint.

    python -m tdanet_tpu_torch.inference CKPT MIX.wav OUT_PREFIX [--device cuda]

writes OUT_PREFIX_s1.wav ... OUT_PREFIX_s{n_src}.wav, each of the input's
length. The model is the one the checkpoint names (``model_name``), else
TDANetBest (a raw state dict names none). The default device is CUDA; the
CPU runs only when asked for.
"""

from __future__ import annotations

import argparse

import torch

from tdanet_tpu_torch.models import BaseModel, load_torch_checkpoint
from tdanet_tpu_torch.utils import read_wav, separate, write_wav


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("wav")
    ap.add_argument("out_prefix", nargs="?", default="separated")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to "
                         "separate on the CPU")
    name = load_torch_checkpoint(args.ckpt).get("model_name") or "TDANetBest"
    model = BaseModel.from_pretrain(name, args.ckpt).to(args.device)
    wav, sr = read_wav(args.wav)
    est = separate(model, wav)
    for i in range(est.shape[0]):
        path = f"{args.out_prefix}_s{i + 1}.wav"
        write_wav(path, est[i], sr)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
