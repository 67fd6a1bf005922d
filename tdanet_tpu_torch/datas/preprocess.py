"""Offline manifest preprocessing (counterpart of
``tdanet_tpu/datas/preprocess.py``; reference: DataPreProcess/process_*.py).

Walks ``{in_dir}/{split}/{channel}`` wav dirs and writes one
``[path, n_frames]`` JSON manifest per channel under ``{out_dir}/{split}``:
the contract the datasets read. The layouts differ only in split names and
channel lists (process_librimix.py:39, process_lrs2.py:35,
process_wham.py:35).

    python -m tdanet_tpu_torch.datas.preprocess --in_dir CORPUS \\
        --out_dir MANIFESTS [--dataset librimix|lrs2|wham|wsj0]
"""

from __future__ import annotations

import json
import os

from tdanet_tpu_torch.utils.audio_io import wav_frames

DATASET_LAYOUTS = {
    "librimix": {
        "splits": ["train-100", "train-360", "dev", "test"],
        "channels": ["mix_clean", "mix_both", "mix_single", "s1", "s2",
                     "noise"],
    },
    "lrs2": {
        "splits": ["train-100", "dev", "test"],
        "channels": ["mix", "s1", "s2"],
    },
    "wham": {
        "splits": ["train-100", "dev", "test"],
        "channels": ["mix_both", "mix_clean", "s1", "s2", "noise"],
    },
    "wsj0": {
        "splits": ["tr", "cv", "tt"],
        "channels": ["mix", "s1", "s2"],
    },
}


def preprocess_one_dir(in_dir, out_dir, out_filename):
    """Scan one wav dir -> ``{out_dir}/{out_filename}.json`` of
    [abspath, n_frames], in file-name order (process_librimix.py:11-34)."""
    file_infos = []
    in_dir = os.path.abspath(in_dir)
    for name in sorted(os.listdir(in_dir)):
        if not name.endswith(".wav"):
            continue
        path = os.path.join(in_dir, name)
        file_infos.append((path, wav_frames(path)))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, out_filename + ".json"), "w") as f:
        json.dump(file_infos, f, indent=4)
    return file_infos


def preprocess_dataset(in_dir, out_dir, dataset="librimix", splits=None,
                       channels=None):
    """The manifests of every split and channel of ``dataset``'s layout
    (or of ``splits`` and ``channels``) that exist under ``in_dir``."""
    layout = DATASET_LAYOUTS[dataset]
    splits = splits or layout["splits"]
    channels = channels or layout["channels"]
    for split in splits:
        split_in = os.path.join(in_dir, split)
        if not os.path.isdir(split_in):
            continue
        for ch in channels:
            ch_dir = os.path.join(split_in, ch)
            if os.path.isdir(ch_dir):
                preprocess_one_dir(ch_dir, os.path.join(out_dir, split), ch)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="Build wav manifest JSONs")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--dataset", default="librimix",
                   choices=sorted(DATASET_LAYOUTS))
    args = p.parse_args(argv)
    preprocess_dataset(args.in_dir, args.out_dir, args.dataset)


if __name__ == "__main__":
    main()
