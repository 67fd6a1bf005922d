"""One rank of the port's data-parallel CPU tests, run as a subprocess per
rank over gloo (``tests/test_torch_parallel_step.py`` and
``tests/test_torch_parallel_trainer.py``). Imports torch, never JAX.

    python tests/torch_parallel_worker.py step SPEC.pt PORT RANK WORLD OUT.pt
    python tests/torch_parallel_worker.py trainer PORT RANK WORLD DATA EXP MODE

``step``: ``SPEC.pt`` holds the model (registry name, config, flat
float64 parameters), the global batch, whether the step runs the
training forward (else the model runs its eval-mode forward: dropout
off), whether every dropout and drop-path rate is set to 0 (``no_drop``)
and the generator's seed. The rank takes its rows, runs one ``make_train_step``
under the process mesh and saves its loss, its gradients as the clip sees
them (summed over ranks), the parameters after the update and the names
whose gradient the loss never reached.

``trainer``: ``AudioTrainer`` on the tiny debug config over the split under
DATA, with an injected fault at the second step on every rank
(``MODE=fail``) or a SIGTERM at the second step on rank 0 only
(``MODE=preempt``); prints one line that the test parses.
"""
import os
import signal
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _join(port, rank, world):
    from tdanet_tpu_torch.parallel import initialize_distributed, make_mesh
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                  device="cpu")
    return make_mesh()


def step(spec_path, port, rank, world, out_path):
    from tdanet_tpu_torch import models
    from tdanet_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from tdanet_tpu_torch.system.optimizers import make_optimizer
    from tdanet_tpu_torch.system.trainer import (create_train_state,
                                                 make_train_step)

    spec = torch.load(spec_path, weights_only=False)
    mesh = _join(port, rank, world)
    model = models.get(spec["name"])(**spec["cfg"]).double()
    if spec.get("no_drop"):
        for m in model.modules():
            for rate in ("drop", "dropout", "drop_path"):
                if isinstance(getattr(m, rate, None), float):
                    setattr(m, rate, 0.0)
    if spec["flat"] is None:  # rank 0's init reaches the others
        gen = torch.Generator().manual_seed(spec["seed"] + 100 * rank)
    else:
        gen = spec["flat"]
    tx = make_optimizer("adam", lr=spec.get("lr", 1e-3), grad_clip=5.0)
    state = create_train_state(model, tx, gen, mesh=mesh)
    model.double()

    if spec["training"]:
        forward = model
    else:
        def forward(mix, training, generator, compute_dtype, dp_group):
            return model(mix, dp_group=dp_group)
    train_step = make_train_step(
        forward, PITLossWrapper(pairwise_neg_snr, threshold_byloss=True),
        tx, mesh=mesh)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads, clip = {}, tx.clip_

    def record(gs):
        grads.update({n: g.clone() for (n, _), g in zip(named, gs)})
        return clip(gs)
    tx.clip_ = record
    n = spec["mix"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    mix = torch.as_tensor(spec["mix"][rows], dtype=torch.float64)
    src = torch.as_tensor(spec["src"][rows], dtype=torch.float64)

    reached = set()
    hooks = [p.register_hook(lambda g, name=name: reached.add(name))
             for name, p in named]
    state, loss = train_step(state, mix, src,
                             torch.Generator().manual_seed(spec["seed"]))
    for h in hooks:
        h.remove()
    torch.save({"loss": loss.item(), "grads": grads,
                "params": {k: v.detach().clone()
                           for k, v in model.named_parameters()},
                "unreached": sorted(n for n, _ in named if n not in reached)},
               out_path)
    torch.distributed.destroy_process_group()
    print(f"RANK {rank} LOSS {loss.item()!r}", flush=True)


def trainer(port, rank, world, data_root, exp_dir, mode):
    from tdanet_tpu_torch.system.training_loop import AudioTrainer
    from tdanet_tpu_torch.utils.parser import load_yaml

    mesh = _join(port, rank, world)
    conf = load_yaml(os.path.join(REPO, "configs", "tdanet_debug.yml"))
    dc = conf["datamodule"]["data_config"]
    dc.update(train_dir=os.path.join(data_root, "tr"),
              valid_dir=os.path.join(data_root, "cv"),
              test_dir=os.path.join(data_root, "cv"), batch_size=4,
              num_workers=0)
    conf["main_args"] = {"exp_dir": exp_dir, "device": "cpu"}
    conf["audionet"]["audionet_config"].update(
        num_blocks=1, upsampling_depth=3, out_channels=16, in_channels=32)
    conf["training"].update(epochs=2, max_step_failures=2)
    conf["exp"] = dict(conf.get("exp", {}), disable_wandb=True)

    tr = AudioTrainer(conf, mesh=mesh)
    orig, calls = tr.train_step, {"n": 0}

    def wrapped(state, mix, src, gen):
        calls["n"] += 1
        if calls["n"] == 2:
            if mode == "fail":  # every rank's step aborts, as a collective
                raise RuntimeError("injected fault")
            if mode == "preempt" and rank == 0:
                os.kill(os.getpid(), signal.SIGTERM)
        return orig(state, mix, src, gen)

    tr.train_step = wrapped
    hist = tr.fit()
    if mode == "preempt":
        last = os.path.join(exp_dir, "last")
        saved = os.path.isdir(last) and bool(os.listdir(last))
        print(f"RANK {rank} PREEMPT_OK epochs={len(hist)} steps={calls['n']}"
              f" last_ckpt={saved}", flush=True)
    else:
        print(f"RANK {rank} EPOCHS {len(hist)} steps={calls['n']} "
              f"VAL {hist[-1]['val_loss']!r}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    kind, *args = sys.argv[1:]
    if kind == "step":
        spec, port, rank, world, out = args
        step(spec, int(port), int(rank), int(world), out)
    else:
        port, rank, world, data, exp, mode = args
        trainer(int(port), int(rank), int(world), data, exp, mode)
