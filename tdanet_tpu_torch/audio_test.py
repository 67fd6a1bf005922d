"""Eval CLI (counterpart of ``audio_test.py``): per-utterance test-set
SI-SNR(i) and SDR(i) written to <exp_dir>/results/metrics.csv with avg and
std rows, and optionally the separated wavs.

    python -m tdanet_tpu_torch.audio_test --conf_dir <exp>/conf.yml \\
        [--ckpt_path path.pth] [--save_output true] [--save_path dir] \\
        [--batch_size 8] [--num_blocks D | --progressive_depth D1 \\
        [--progressive_threshold 0.05] | --bundle dir] [--device cuda|cpu]

The experiment directory is ``main_args.exp_dir`` of the conf when the
trainer wrote one, else Experiments/checkpoint/<exp_name>; the checkpoint
defaults to its best_model.pth. ``--bundle`` evaluates through a
deployment bundle (``python -m tdanet_tpu_torch.export_bundle``) in place
of the checkpoint and the model code. The device is CUDA unless
``--device cpu`` asks for the CPU; without a card it raises. The exit code
is 1 when the result is empty or not finite.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from tdanet_tpu_torch import datas as data_zoo
from tdanet_tpu_torch.metrics import MetricsTracker
from tdanet_tpu_torch.utils import separate, write_wav
from tdanet_tpu_torch.utils.parser import load_yaml


def experiment_dir(conf):
    """The run's directory: the one the trainer recorded, else the JAX
    CLI's Experiments/checkpoint/<exp_name>."""
    return (conf.get("main_args") or {}).get("exp_dir") or os.path.join(
        "Experiments", "checkpoint", conf["exp"]["exp_name"])


def resolve_device(name):
    """``torch.device(name)``; CUDA without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU")
    return torch.device(name)


def load_model(conf, ckpt, device):
    """The conf's model from ``ckpt``, on ``device``, in eval mode."""
    from tdanet_tpu_torch.models import BaseModel
    sr = conf["datamodule"]["data_config"]["sample_rate"]
    model = BaseModel.from_pretrain(
        conf["audionet"]["audionet_name"], ckpt, sample_rate=sr,
        **conf["audionet"]["audionet_config"])
    return model.to(device)


def build_parser():
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--conf_dir", required=True)
    p.add_argument("--ckpt_path", default=None)
    p.add_argument("--save_output", default="False")
    p.add_argument("--save_path", default="./separated")
    p.add_argument("--batch_size", type=int, default=8,
                   help="bucketed batched eval; 1 = the reference's loop")
    p.add_argument("--num_blocks", type=int, default=None,
                   help="early-exit depth of the shared-weight recurrence")
    p.add_argument("--progressive_depth", type=int, default=None,
                   help="adaptive depth: every utterance at this depth, "
                        "then the exact continuation to full depth of the "
                        "ones whose recurrence has not converged "
                        "(tdanet_tpu_torch/progressive.py)")
    p.add_argument("--progressive_threshold", type=float, default=0.05,
                   help="escalate utterances whose last-iteration relative "
                        "delta is above this (with --progressive_depth)")
    p.add_argument("--dp", type=int, default=None,
                   help="1 (or less) is the one-device path, as in the "
                        "JAX CLI; above 1 needs a mesh, not ported yet "
                        "(ROADMAP A #10)")
    p.add_argument("--bundle", default=None,
                   help="evaluate through a deployment bundle "
                        "(python -m tdanet_tpu_torch.export_bundle) instead "
                        "of the model code: the shipped artifact's metrics; "
                        "the bundle must export every test-set length "
                        "(--lengths_from_manifest at export)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.bundle is not None and (
            args.num_blocks is not None
            or args.progressive_depth is not None
            or (args.dp or 0) > 1):
        p.error("--bundle serves fixed exported programs; "
                "--num_blocks/--progressive_depth/--dp do not apply "
                "(choose depth and dtype at export)")
    if args.dp is not None and args.dp > 1:
        p.error("--dp above 1 is not ported yet: parallel/mesh.py has no "
                "counterpart in tdanet_tpu_torch (ROADMAP A #10)")
    if args.progressive_depth is not None and args.num_blocks is not None:
        p.error("--progressive_depth is exclusive with --num_blocks "
                "(adaptive depth subsumes the fixed override)")
    device = resolve_device(args.device)

    conf = load_yaml(args.conf_dir)
    exp_dir = experiment_dir(conf)
    ckpt = args.ckpt_path or os.path.join(exp_dir, "best_model.pth")
    sr = conf["datamodule"]["data_config"]["sample_rate"]
    if args.bundle is not None:
        # no model code and no checkpoint: the bundle carries programs and
        # weights (tdanet_tpu_torch/deploy.py)
        from tdanet_tpu_torch import deploy
        dep = deploy.load_bundle(args.bundle, device=device)
        if dep.sample_rate != sr:
            raise SystemExit(
                f"bundle was exported at {dep.sample_rate} Hz but the "
                f"config's test set is {sr} Hz")
        model = None
    else:
        model = load_model(conf, ckpt, device)

    dm = getattr(data_zoo, conf["datamodule"]["data_name"])(
        **{**conf["datamodule"]["data_config"], "segment": None})
    dm.setup()
    _, _, test_set = dm.make_sets

    results_dir = os.path.join(exp_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    metrics = MetricsTracker(os.path.join(results_dir, "metrics.csv"))

    save = args.save_output.lower() == "true"
    from tdanet_tpu_torch.utils.progress import eval_progress
    from tdanet_tpu_torch.utils.separator import separate_batched_stream
    progress, metrics_col = eval_progress("Testing")

    def emit(done, mix, sources, key, est):
        metrics(mix=mix, clean=sources, estimate=est, key=key)
        if save:
            for s in range(est.shape[0]):
                write_wav(os.path.join(args.save_path, f"s{s + 1}", key),
                          np.asarray(est[s]), sr)
        if done % 50 == 0:
            metrics_col.update(metrics.update())

    lengths = [test_set.mix[i][1] for i in range(len(test_set))]
    with progress:
        if args.bundle is not None:
            B = dep.batch_size
            done = 0
            for s0 in progress.track(range(0, len(test_set), B)):
                items = [test_set[i]
                         for i in range(s0, min(len(test_set), s0 + B))]
                ests = dep.separate_batched([it[0] for it in items])
                for item, est in zip(items, ests):
                    emit(done, *item, est)
                    done += 1
        elif args.progressive_depth is not None:
            from tdanet_tpu_torch.progressive import \
                separate_progressive_stream
            pstats = {}
            stream = separate_progressive_stream(
                model, lengths, lambda i: test_set[i],
                depth1=args.progressive_depth,
                threshold=args.progressive_threshold,
                batch_size=max(args.batch_size, 1), stats=pstats)
            for done, (_, item, est) in enumerate(
                    progress.track(stream, total=len(test_set))):
                emit(done, *item, est)
            print(f"progressive: depth {pstats['depth1']}->"
                  f"{pstats['depth_full']}, escalated "
                  f"{pstats['n_escalated']}/{pstats['n']} "
                  f"(mean delta {pstats['delta_mean']:.4f})")
        elif args.batch_size > 1:
            # wav IO prefetches on a thread; metrics and wav writes for one
            # batch overlap the next batch's forward
            stream = separate_batched_stream(
                model, lengths, lambda i: test_set[i],
                batch_size=args.batch_size, num_blocks=args.num_blocks)
            for done, (_, item, est) in enumerate(
                    progress.track(stream, total=len(test_set))):
                emit(done, *item, est)
        else:
            for idx in progress.track(range(len(test_set))):
                mix, sources, key = test_set[idx]
                est = separate(model, mix, num_blocks=args.num_blocks)
                emit(idx, mix, sources, key, est)
    final = metrics.final()
    print("final:", final)
    return final


def ok(final):
    """A result a CI gate accepts: not empty, every value finite."""
    return bool(final) and all(math.isfinite(v) for v in final.values())


if __name__ == "__main__":
    sys.exit(0 if ok(main()) else 1)
