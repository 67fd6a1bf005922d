"""Long-form continuous speech separation CLI (counterpart of
``audio_test_css.py``, stitch mode): each recording is cut into overlapped
segments, the segments are separated, joined by overlap-add with
cosine-similarity permutation alignment (``utils/css.py``), trimmed of the
tail's zero padding, and written one wav per source.

    python -m tdanet_tpu_torch.audio_test_css --conf_dir <exp>/conf.yml \\
        [--ckpt_path p] [--test_dir dir] [--segment 4.0] [--overlap 0.25] \\
        [--progressive_depth D1 [--progressive_threshold t]] \\
        [--save_path dir] [--device cuda|cpu]

``--mode sp`` (one sequence-parallel forward) is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from tdanet_tpu_torch import datas as data_zoo
from tdanet_tpu_torch.audio_test import (experiment_dir, load_model,
                                         resolve_device)
from tdanet_tpu_torch.utils import write_wav
from tdanet_tpu_torch.utils.css import stitch_segments
from tdanet_tpu_torch.utils.parser import load_yaml


def main(argv=None):
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--conf_dir", required=True)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--save_path", default="./separated_css")
    p.add_argument("--test_dir", default=None,
                   help="dir of long-form wavs (overrides the config)")
    p.add_argument("--segment", type=float, default=None)
    p.add_argument("--overlap", type=float, default=None)
    p.add_argument("--mode", choices=["stitch", "sp"], default="stitch",
                   help="stitch: segments + overlap-add; sp is not ported "
                        "yet (parallel/sequence.py)")
    p.add_argument("--progressive_depth", type=int, default=None,
                   help="adaptive-depth segment separation: stage 1 at this "
                        "depth, the exact continuation of unconverged "
                        "segments to full depth")
    p.add_argument("--progressive_threshold", type=float, default=0.05)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.mode == "sp":
        p.error("--mode sp is not ported yet: parallel/sequence.py has no "
                "counterpart in tdanet_tpu_torch")
    device = resolve_device(args.device)

    conf = load_yaml(args.conf_dir)
    ckpt = args.ckpt_path or os.path.join(experiment_dir(conf),
                                          "best_model.pth")
    dc = conf["datamodule"]["data_config"]
    sr = dc["sample_rate"]
    model = load_model(conf, ckpt, device)

    segment = args.segment or dc.get("segment", 4.0)
    overlap = args.overlap if args.overlap is not None \
        else dc.get("overlap", 0.25)
    if conf["datamodule"]["data_name"] == "LibriCSSDataModule" \
            and args.test_dir is None:
        # the resolved segment and overlap reach the slicer too: the
        # stitcher's overlap_len below is computed from them
        dm = data_zoo.LibriCSSDataModule(
            **dict(dc, segment=segment, overlap=overlap))
    else:
        if args.test_dir is None:
            p.error("--test_dir is required unless the config uses "
                    "LibriCSSDataModule")
        dm = data_zoo.LibriCSSDataModule(
            test_dir=args.test_dir, n_src=dc.get("n_src", 2),
            sample_rate=sr, segment=segment, overlap=overlap)
    dm.setup()
    _, _, test_set = dm.make_sets
    overlap_len = int(sr * segment * overlap)
    t0 = time.time()
    for idx in range(len(test_set)):
        f_name, segments, pad_len = test_set[idx]
        streams = stitch_segments(
            model, segments, overlap_len,
            progressive_depth=args.progressive_depth,
            progressive_threshold=args.progressive_threshold)
        if pad_len:
            streams = streams[:, :-pad_len]
        for s in range(streams.shape[0]):
            write_wav(os.path.join(args.save_path, f"s{s + 1}", f_name),
                      streams[s], sr)
    print(f"Deal time: [{time.time() - t0:.2f}] seconds for "
          f"[{len(test_set)}] items.")


if __name__ == "__main__":
    sys.exit(main())
