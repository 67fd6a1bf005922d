"""Train CLI (counterpart of ``audio_train.py``): config-driven training
with checkpoints, early stopping and the best_model.pth export.

    python -m tdanet_tpu_torch.audio_train --conf_dir configs/tdanet.yml \\
        [--device cpu|cuda|cuda:N] [a.b.c=value ...]

The device is CUDA unless ``--device cpu`` (or ``main_args.device=cpu``)
asks for the CPU; without a card it raises. The experiment directory is
``main_args.exp_dir`` when given, else Experiments/checkpoint/<exp_name>;
``main_args.resume=true`` resumes from its last checkpoint.

Data parallelism: started as N ranks (``python -m
tdanet_tpu_torch.launch_multihost --nprocs N -- audio_train ...`` or
``torchrun --nproc_per_node N -m tdanet_tpu_torch.audio_train ...``), each
rank joins the process group (NCCL for CUDA ranks unless
``TDANET_DIST_BACKEND`` says otherwise, gloo for CPU ranks), drives
``cuda:LOCAL_RANK`` (or the device named) and trains on its slice of
every batch; ``datamodule.data_config.batch_size`` is the global batch.
"""

from __future__ import annotations

import argparse
import os

import torch

from tdanet_tpu_torch.utils.parser import parse_config, save_yaml


def make_rank_mesh(config):
    """Join the process group when this process is one of several ranks
    (torchrun's environment) and return the mesh of its device; None on
    one process."""
    from tdanet_tpu_torch.parallel import initialize_distributed, make_mesh
    from tdanet_tpu_torch.system.training_loop import resolve_device

    name = config["main_args"].get("device") or "cuda"
    if not initialize_distributed(device=name):
        return None
    return make_mesh(devices=[resolve_device(name)])


# MACs a segment by (model class, its config, segment samples): a count
# takes seconds of host time, and a process may start several runs of one
# model (a resume)
_MACS = {}


def model_size(model, config):
    """The parameters and the MACs of one segment's forward (B=1; 1 s
    where the config has no segment), as the JAX ``audio_train.py``
    prints them; the parameters alone where the MAC count fails."""
    from tdanet_tpu_torch.utils.profiling import count_macs, count_params
    data = config["datamodule"]["data_config"]
    T = int(data["sample_rate"] * (data.get("segment") or 1.0))
    size = f"{count_params(model) / 1e6:.2f}M params"
    key = (type(model).__name__, repr(config["audionet"]),
           data["sample_rate"], T)
    if key not in _MACS:
        try:
            _MACS[key] = count_macs(model, torch.zeros(1, T))
        except Exception as e:  # a count is not worth a failed run
            return f"{size} (MACs not counted: {type(e).__name__})"
    return f"{size}, {_MACS[key] / 1e9:.2f} GMACs/segment"


def main(config):
    """Train from a resolved config; returns the AudioTrainer."""
    from tdanet_tpu_torch.system.training_loop import AudioTrainer

    main_args = config.setdefault("main_args", {})
    exp_dir = main_args.get("exp_dir") or os.path.join(
        "Experiments", "checkpoint", config["exp"]["exp_name"])
    main_args["exp_dir"] = exp_dir
    mesh = make_rank_mesh(config)
    try:
        if mesh is None or mesh.rank == 0:
            os.makedirs(exp_dir, exist_ok=True)
            save_yaml(os.path.join(exp_dir, "conf.yml"), config)
        trainer = AudioTrainer(config, mesh=mesh)
        where = f"device={trainer.device}" if mesh is None else (
            f"{mesh.dp} ranks, rank {mesh.rank} on {trainer.device}")
        if trainer.rank == 0:
            trainer.log(f"Model {config['audionet']['audionet_name']}: "
                        f"{model_size(trainer.model, config)}, {where}")
        trainer.fit(resume=bool(main_args.get("resume")))
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    return trainer


def cli(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    ns, rest = ap.parse_known_args(argv)
    config = parse_config(rest, default_conf="configs/tdanet.yml")
    if ns.device:
        if ns.device.split(":")[0] not in ("cuda", "cpu"):
            ap.error(f"--device {ns.device}: cpu, cuda or cuda:N")
        config["main_args"]["device"] = ns.device
    return main(config)


if __name__ == "__main__":
    cli()
