"""Export a deployment bundle from a reference-format checkpoint
(counterpart of ``scripts/export_bundle.py``).

    python -m tdanet_tpu_torch.export_bundle --ckpt best_model.pth \\
        --out bundle/ --lengths 1.0 2.0 3.0 [--model TDANetBest] \\
        [--batch 8] [--dtype bfloat16] [--num_blocks 12] \\
        [--devices cuda cpu] [--lengths_from_manifest tt/mix_clean.json] \\
        [--streaming_segment 1.0 --streaming_max_streams 4] \\
        [--early_exit 8 12] [--progressive_depth 8]

The bundle (``torch.export`` programs, weights and meta; see
``tdanet_tpu_torch/deploy.py``) then serves through ``deploy.load_bundle``
with no model code. The model is traced on each device of ``--devices``
(default cuda: kernel #1 launches inside the programs), so a CUDA export
needs the card.
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    ap = argparse.ArgumentParser(
        description=__doc__, allow_abbrev=False,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True,
                    help="reference-format .pth/.bin checkpoint")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--lengths", type=float, nargs="+", default=[],
                    help="utterance lengths (seconds); one program per "
                         "lattice-distinct length")
    ap.add_argument("--lengths_from_manifest", nargs="+", default=[],
                    help="dataset manifest JSON(s) ([path, n_frames] rows, "
                         "e.g. tt/mix_clean.json): export every length the "
                         "split needs, so audio_test --bundle covers it "
                         "lattice-exactly")
    ap.add_argument("--model", default=None,
                    help="registry name (default: the checkpoint's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default=None,
                    help="compute dtype, e.g. bfloat16 (default fp32)")
    ap.add_argument("--num_blocks", type=int, default=None,
                    help="early-exit depth override")
    ap.add_argument("--devices", nargs="+", default=["cuda"],
                    help="devices to export for, one program file each "
                         "(a program runs only on its own)")
    ap.add_argument("--streaming_segment", type=float, default=None,
                    help="also export a live-streaming program at this "
                         "segment length (seconds); served by "
                         "deploy.load_streaming")
    ap.add_argument("--streaming_max_streams", type=int, default=4)
    ap.add_argument("--streaming_overlap", type=float, default=0.25)
    ap.add_argument("--early_exit", type=int, nargs="+", default=[],
                    help="also export each bucket at these depths; served "
                         "by deploy.load_bundle(num_blocks=d)")
    ap.add_argument("--progressive_depth", type=int, default=None,
                    help="also export the adaptive-depth stage pair (stage "
                         "1 at this depth); served by "
                         "deploy.load_progressive")
    ap.add_argument("--progressive_threshold", type=float, default=0.05)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    from tdanet_tpu_torch import deploy
    from tdanet_tpu_torch.models import BaseModel

    model = BaseModel.from_pretrain(args.model or args.ckpt, args.ckpt)
    lengths = list(args.lengths)
    if args.lengths_from_manifest:
        sr = model.sample_rate()
        for mpath in args.lengths_from_manifest:
            with open(mpath) as f:
                lengths += [n / sr for _path, n in json.load(f)]
    streaming = None
    if args.streaming_segment is not None:
        streaming = dict(segment=args.streaming_segment,
                         max_streams=args.streaming_max_streams,
                         overlap=args.streaming_overlap)
    if not lengths and streaming is None:
        ap.error("pass --lengths, --lengths_from_manifest and/or "
                 "--streaming_segment")
    progressive = None
    if args.progressive_depth is not None:
        progressive = dict(depth1=args.progressive_depth,
                           threshold=args.progressive_threshold)
    meta = deploy.save_bundle(args.out, model, lengths=lengths,
                              batch_size=args.batch,
                              compute_dtype=args.dtype,
                              num_blocks=args.num_blocks,
                              devices=args.devices, streaming=streaming,
                              early_exit=args.early_exit,
                              progressive=progressive)
    for fname, rec in meta["programs"].items():
        print(f"  {fname}: exported in {rec['export_s']:.2f} s, "
              f"{rec['bytes'] / 1e6:.2f} MB")
    extra = (f" + streaming S{meta['streaming']['seg_len']}"
             f"x{meta['streaming']['max_streams']}"
             if "streaming" in meta else "")
    if "early_exit" in meta:
        extra += f" + early-exit depths {meta['early_exit']}"
    if "progressive" in meta:
        extra += (f" + progressive d1={meta['progressive']['depth1']}"
                  f"/{meta['progressive']['depth_full']}")
    print(f"exported {len(meta['targets'])} program(s) "
          f"{meta['targets']} (batch {meta['batch_size']}, "
          f"devices {meta['devices']}){extra} -> {args.out}")
    return meta


if __name__ == "__main__":
    main()
