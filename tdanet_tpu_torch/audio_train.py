"""Train CLI (counterpart of ``audio_train.py``): config-driven training
with checkpoints, early stopping and the best_model.pth export.

    python -m tdanet_tpu_torch.audio_train --conf_dir configs/tdanet.yml \\
        [--device cpu] [a.b.c=value ...]

The device is CUDA unless ``--device cpu`` (or ``main_args.device=cpu``)
asks for the CPU; without a card it raises. The experiment directory is
``main_args.exp_dir`` when given, else Experiments/checkpoint/<exp_name>;
``main_args.resume=true`` resumes from its last checkpoint.
"""

from __future__ import annotations

import argparse
import os

from tdanet_tpu_torch.utils.parser import parse_config, save_yaml


def main(config):
    """Train from a resolved config; returns the AudioTrainer."""
    from tdanet_tpu_torch.system.training_loop import AudioTrainer

    main_args = config.setdefault("main_args", {})
    exp_dir = main_args.get("exp_dir") or os.path.join(
        "Experiments", "checkpoint", config["exp"]["exp_name"])
    main_args["exp_dir"] = exp_dir
    os.makedirs(exp_dir, exist_ok=True)
    save_yaml(os.path.join(exp_dir, "conf.yml"), config)

    trainer = AudioTrainer(config)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"Model {config['audionet']['audionet_name']}: "
          f"{n_params / 1e6:.2f}M params, device={trainer.device}")
    trainer.fit(resume=bool(main_args.get("resume")))
    return trainer


def cli(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ns, rest = ap.parse_known_args(argv)
    config = parse_config(rest, default_conf="configs/tdanet.yml")
    if ns.device:
        config["main_args"]["device"] = ns.device
    return main(config)


if __name__ == "__main__":
    cli()
