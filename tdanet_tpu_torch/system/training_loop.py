"""Config-driven training loop (counterpart of
``tdanet_tpu/system/training_loop.py``):

- one eager step per batch on one device: forward, loss, backward, the
  optimizer's global-norm clip and update (``system/trainer.py``);
- host-side schedulers writing the learning rate into the optimizer;
- top-3 + last checkpoints with optimizer and scheduler state;
- early stopping on the validation loss, a test-set pass every 10 epochs;
- optional speed perturbation (95/100/105%, re-mixed targets) on the host;
- recovery from a failing step (restore the last checkpoint, up to
  ``training.max_step_failures`` times) and SIGTERM/SIGINT preemption
  (finish the step, checkpoint, exit; a resume starts at the next epoch);
- ``best_model.pth`` in the reference schema at the end.

Under a process mesh (``AudioTrainer(config, mesh=)``, one process a rank,
as ``launch_multihost`` or torchrun start them) every rank loads the same
batches in the same order and trains on its slice of each; the step is the
global batch's (``system/trainer.py``). Host-side decisions are taken by
every rank in the same iteration: a step failure or a preemption on any
rank is OR-ed over ranks (``_sync_flags``), so all ranks restore, or stop,
at the same batch. The validation loss is summed and counted over ranks.
Rank 0 alone writes checkpoints and the exports and prints; every rank
restores, after a barrier.
"""

from __future__ import annotations

import copy
import inspect
import json
import os
import signal
import time
from typing import Any, Dict

import numpy as np
import torch
from scipy.signal import resample_poly

from tdanet_tpu_torch.losses import (PITLossWrapper, pairwise_neg_sisdr,
                                     pairwise_neg_snr)
from tdanet_tpu_torch.models import base as model_zoo
from tdanet_tpu_torch.parallel import collectives
from tdanet_tpu_torch.system.checkpoint import (CheckpointManager,
                                                export_torch_pth)
from tdanet_tpu_torch.system.optimizers import (get_learning_rate,
                                                make_optimizer,
                                                set_learning_rate)
from tdanet_tpu_torch.system.schedulers import make_scheduler
from tdanet_tpu_torch.system.trainer import (TrainState, create_train_state,
                                             dp_group_of, make_eval_step,
                                             make_train_step)

LOSS_TABLE = {
    "pairwise_neg_snr": pairwise_neg_snr,
    "pairwise_neg_sisdr": pairwise_neg_sisdr,
}


def build_loss(loss_conf):
    def one(side):
        c = loss_conf[side]
        return PITLossWrapper(
            LOSS_TABLE[c["sdr_type"]],
            pit_from=c["config"].get("pit_from", "pw_mtx"),
            threshold_byloss=c["config"].get("threshold_byloss", False))
    return {"train": one("train"), "val": one("val")}


def speed_perturb_batch(targets: np.ndarray, rng: np.random.Generator,
                        speeds=(95, 100, 105)) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Per-source random resample then re-mix; crop to the fixed minimum
    length (seg*100/max_speed) so every batch has one shape."""
    B, n_src, T = targets.shape
    out_T = (T * 100) // max(speeds)
    new = np.zeros((B, n_src, out_T), np.float32)
    for i in range(n_src):
        speed = int(rng.choice(speeds))
        if speed == 100:
            new[:, i] = targets[:, i, :out_T]
        else:
            res = resample_poly(targets[:, i], 100, speed, axis=-1)
            new[:, i] = res[:, :out_T]
    return new.sum(1), new


def resolve_device(name):
    """The training device: CUDA unless the CPU is asked for; no card
    raises. Inside a process group "cuda" is this rank's card,
    ``cuda:LOCAL_RANK``; a named device (``cuda:0``) is taken as it is."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and device.index is None \
            and torch.distributed.is_initialized():
        from tdanet_tpu_torch.parallel.mesh import local_rank
        device = torch.device("cuda", local_rank())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; set main_args.device=cpu "
                           "(or pass --device cpu) to train on the CPU")
    return device


class AudioTrainer:
    """End-to-end trainer driven by a reference-shaped config dict."""

    def __init__(self, config: Dict[str, Any], mesh=None):
        self.config = config
        main_args = config.get("main_args", {})
        self.mesh = mesh
        self.group = dp_group_of(mesh)
        self.rank = mesh.rank if mesh is not None else 0
        self.device = mesh.device if mesh is not None else \
            resolve_device(main_args.get("device"))
        self.exp_dir = main_args.get("exp_dir") or os.path.join(
            "Experiments", "checkpoint", config["exp"]["exp_name"])
        os.makedirs(self.exp_dir, exist_ok=True)

        # model; training checkpoints each iteration by default (remat
        # "scales", the JAX package's default; Recurrent's docstring)
        net = config["audionet"]
        sr = config["datamodule"]["data_config"]["sample_rate"]
        net_conf = dict(net["audionet_config"])
        cls = model_zoo.get(net["audionet_name"])
        if "remat" in inspect.signature(cls.__init__).parameters:
            net_conf.setdefault("remat", "scales")
        self.model = cls(sample_rate=sr, **net_conf)

        from tdanet_tpu_torch import datas
        dm_cls = getattr(datas, config["datamodule"]["data_name"])
        self.datamodule = dm_cls(**config["datamodule"]["data_config"])
        self.datamodule.setup()
        self.dp = mesh.dp if mesh is not None else 1

        opt_conf = dict(config["optimizer"])
        optim_name = opt_conf.pop("optim_name", "adam")
        self.base_lr = opt_conf.pop("lr", 1e-3)
        grad_clip = config["training"].get("gradient_clip_val", 5.0)
        self.optimizer = make_optimizer(optim_name, lr=self.base_lr,
                                        grad_clip=grad_clip, **opt_conf)
        sche = config.get("scheduler") or {}
        steps_per_epoch = max(1, len(self.datamodule.train_dataloader()))
        self.scheduler = make_scheduler(
            sche.get("sche_name", "none"), self.base_lr,
            steps_per_epoch=steps_per_epoch,
            d_model=net["audionet_config"].get("in_channels", 512),
            **sche.get("sche_config", {})) if sche else None
        self.epoch_scheduler = sche.get("sche_name", "").lower() == \
            "reducelronplateau"

        self.loss = build_loss(config["loss"])
        self.compute_dtype = (
            torch.bfloat16 if str(config["training"].get("precision", 32))
            in ("16", "bf16", "16-mixed") else None)
        self.train_step = make_train_step(
            self.model, self.loss["train"], self.optimizer, mesh=mesh,
            compute_dtype=self.compute_dtype)
        self.eval_step = make_eval_step(self.model, self.loss["val"],
                                        mesh=mesh)
        self.ckpt = CheckpointManager(self.exp_dir, top_k=3)
        self.history: list[Dict[str, float]] = []
        self.best_model = None
        # wandb logging, offline-capable and optional
        self._wandb = None
        exp = config.get("exp", {})
        if exp.get("project") and not exp.get("disable_wandb") \
                and self.rank == 0:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                mode = "offline" if exp.get("offline", True) else "online"
                try:
                    self._wandb = wandb.init(
                        project=exp["project"], name=exp.get("exp_name"),
                        config=config, mode=mode, dir=self.exp_dir)
                except Exception as e:  # logging must not stop training
                    print(f"wandb disabled: {type(e).__name__}: {e}")

    # -- ranks -------------------------------------------------------------

    def log(self, *args):
        """Print on rank 0 only."""
        if self.rank == 0:
            print(*args, flush=True)

    def _on_rank0(self, fn, *args):
        """Run ``fn`` (a file write) on rank 0, then wait for every rank,
        so that no rank reads a file before it is written."""
        if self.rank == 0:
            fn(*args)
        collectives.barrier(self.group)

    # -- loops -------------------------------------------------------------

    def _new_state(self, cfg_t):
        return create_train_state(
            self.model, self.optimizer,
            torch.Generator().manual_seed(cfg_t.get("seed", 0)),
            mesh=self.mesh, device=self.device)

    def _device_batch(self, mix, src):
        """This rank's rows of the batch on the device: the batch trimmed
        to a multiple of dp, then rows ``pi*B_loc:(pi+1)*B_loc`` of it
        (every rank loads the same batches in the same order)."""
        B = (mix.shape[0] // self.dp) * self.dp
        if B == 0:
            return None, None
        n = B // self.dp
        rows = slice(self.rank * n, (self.rank + 1) * n)
        return (torch.from_numpy(np.asarray(mix[rows], np.float32))
                .to(self.device),
                torch.from_numpy(np.asarray(src[rows], np.float32))
                .to(self.device))

    def _sync_flags(self, *flags: bool) -> tuple:
        """OR each host-side flag over ranks (one all-reduce; the flags
        themselves on one process). Step failures, preemption and empty
        epochs are decided by every rank in the same iteration: a rank
        that broke off, saved or restored alone would leave the others
        waiting in the next step's collectives."""
        return collectives.any_rank(flags, self.group)

    def _restore_or_reinit(self, cfg_t):
        """Roll back to the last checkpoint after a step failure (a fresh
        init when none has been written yet), the scheduler with it."""
        try:
            self.state, _ = self.ckpt.restore_last(self.state)
            if self.scheduler is not None:
                extras = self.ckpt.load_extras()
                if "scheduler" in extras:
                    self.scheduler.load_state_dict(extras["scheduler"])
        except FileNotFoundError:
            self.state = self._new_state(cfg_t)

    def validate(self, loader) -> float:
        """Mean eval loss over the batches, summed and counted over ranks,
        so that every rank (and ``ReduceLROnPlateau`` on it) sees the same
        value; the losses stay on the device until the mean."""
        losses = []
        for mix, src, _ in loader:
            mix, src = self._device_batch(mix, src)
            if mix is None:
                continue
            losses.append(self.eval_step(mix, src))
        if not losses:
            return float("inf")
        total = torch.stack([torch.stack(losses).sum().double(),
                             torch.tensor(float(len(losses)),
                                          dtype=torch.float64,
                                          device=losses[0].device)])
        total = collectives.all_sum(total, self.group)
        return float(total[0] / total[1])

    def fit(self, resume: bool = False):
        cfg_t = self.config["training"]
        epochs = cfg_t.get("epochs", 500)
        patience = cfg_t.get("early_stop", {}).get("patience", 30)
        speed_aug = bool(cfg_t.get("SpeedAug", False))
        max_failures = int(cfg_t.get("max_step_failures", 3))
        self._preempted = False

        def _on_term(signum, frame):
            if self._preempted:
                # second signal: the graceful path is stuck; let a
                # supervisor's escalation kill the process
                raise KeyboardInterrupt(
                    f"second signal {signum} during preemption shutdown")
            self._preempted = True
        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_term)
            except ValueError:  # not the main thread
                pass
        try:
            return self._fit_body(cfg_t, epochs, patience, speed_aug,
                                  max_failures, resume)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _fit_body(self, cfg_t, epochs, patience, speed_aug, max_failures,
                  resume):
        self.state = self._new_state(cfg_t)
        start_epoch = 0
        if resume:
            try:
                self.state, step = self.ckpt.restore_last(self.state)
                extras = self.ckpt.load_extras()
                start_epoch = extras.get("epoch", 0) + 1
                if self.scheduler is not None and "scheduler" in extras:
                    self.scheduler.load_state_dict(extras["scheduler"])
                self.log(f"Resumed from step {step}, epoch {start_epoch}")
            except FileNotFoundError:
                self.log("No checkpoint found; training from scratch")

        train_loader = self.datamodule.train_dataloader()
        val_loader = self.datamodule.val_dataloader()
        test_loader = self.datamodule.test_dataloader()
        rng_host = np.random.default_rng(1234)
        best_val, bad_epochs = float("inf"), 0
        failures = 0

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_losses = []
            for b, (mix, src, _) in enumerate(train_loader):
                if speed_aug:
                    mix, src = speed_perturb_batch(src, rng_host)
                mix, src = self._device_batch(mix, src)
                if mix is None:
                    continue
                if self.scheduler is not None and not self.epoch_scheduler:
                    set_learning_rate(self.state.optimizer,
                                      self.scheduler.step())
                gen = torch.Generator().manual_seed(
                    (epoch << 20) | (b & 0xFFFFF))
                step_exc = None
                try:
                    self.state, loss = self.train_step(self.state, mix, src,
                                                       gen)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:  # recovered below, up to a limit
                    step_exc = e
                    self.log(f"train step failed ({type(e).__name__}: "
                          f"{str(e)[:200]})")
                failed, preempted = self._sync_flags(
                    step_exc is not None, self._preempted)
                self._preempted = self._preempted or preempted
                if failed:
                    failures += 1
                    self.log(f"restoring the last checkpoint on every rank "
                             f"[{failures}/{max_failures}]")
                    if failures > max_failures:
                        raise step_exc if step_exc is not None else \
                            RuntimeError("a peer rank's train step failed")
                    self._restore_or_reinit(cfg_t)
                    continue
                train_losses.append(loss)
                if preempted:
                    break
            train_loss = float(torch.stack(train_losses).mean()) \
                if train_losses else float("nan")

            epoch_preempted, any_rank_empty = self._sync_flags(
                self._preempted, not train_losses)
            self._preempted = self._preempted or epoch_preempted
            if any_rank_empty and not epoch_preempted:
                if failures:
                    raise RuntimeError(
                        f"every train step this epoch failed ({failures} "
                        f"failure(s) recovered; see the errors above)")
                raise RuntimeError(
                    "every training batch was dropped: the data split has "
                    "fewer utterances than datamodule.data_config."
                    "batch_size")
            if epoch_preempted:
                # no validation: preemption grace windows are short;
                # val_loss=inf keeps this save out of the top-k
                extras = {"epoch": epoch, "val_loss": float("inf")}
                if self.scheduler is not None:
                    extras["scheduler"] = self.scheduler.state_dict()
                self._on_rank0(self.ckpt.save, epoch, self.state,
                               float("inf"), extras)
                self.log(f"Preempted: checkpointed epoch {epoch}, exiting "
                      f"cleanly (resume to continue)")
                break

            val_loss = self.validate(val_loader)
            row = {"epoch": epoch, "train_loss": train_loss,
                   "val_loss": val_loss,
                   "lr": float(get_learning_rate(self.state.optimizer)),
                   # the slowest rank's: every rank's row is the same
                   "time_s": collectives.all_max(time.time() - t0,
                                                 self.group)}
            if (epoch + 1) % 10 == 0 and test_loader is not None:
                row["test_loss"] = self.validate(test_loader)
            self.history.append(row)
            self.log(json.dumps(row))
            if self._wandb is not None:
                self._wandb.log(row, step=epoch)

            if self.scheduler is not None and self.epoch_scheduler:
                set_learning_rate(self.state.optimizer,
                                  self.scheduler.step(val_loss))

            extras = {"epoch": epoch, "val_loss": val_loss}
            if self.scheduler is not None:
                extras["scheduler"] = self.scheduler.state_dict()
            self._on_rank0(self.ckpt.save, epoch, self.state, val_loss,
                           extras)

            if val_loss < best_val:
                best_val, bad_epochs = val_loss, 0
            else:
                bad_epochs += 1
                if bad_epochs >= patience:
                    self.log(f"Early stopping at epoch {epoch}")
                    break

        self.ckpt.wait()
        self.finalize()
        return self.history

    def finalize(self):
        """Export the best checkpoint's model as best_model.pth (the last
        state when no best one exists), with the history and the kept
        steps. ``self.state`` keeps the last state; ``self.best_model`` is
        the exported model."""
        best = TrainState(copy.deepcopy(self.state.model), None,
                          self.state.step)
        best.optimizer = self.optimizer.init(best.model.parameters())
        try:
            best, best_step = self.ckpt.restore_best(best)
        except FileNotFoundError:
            best_step = -1
        self.best_model = best.model
        self._check_ranks_agree()
        self._on_rank0(self._export, best_step)
        self.log(f"Exported best_model.pth (step {best_step}) to "
                 f"{self.exp_dir}")

    def _check_ranks_agree(self):
        """Under a process mesh: every rank's history must equal rank 0's,
        row for row (the losses are the global batch's on every rank)."""
        if self.group is None:
            return
        rows = [None] * self.dp
        torch.distributed.all_gather_object(rows, self.history,
                                            group=self.group)
        if any(r != rows[0] for r in rows):
            raise RuntimeError(f"the ranks' histories differ: {rows}")
        self.log(f"history rows equal on {self.dp} ranks")

    def _export(self, best_step):
        with open(os.path.join(self.exp_dir, "history.json"), "w") as f:
            json.dump(self.history, f, indent=2)
        with open(os.path.join(self.exp_dir, "best_k_models.json"),
                  "w") as f:
            json.dump({"best_step": best_step,
                       "kept_steps": self.ckpt.all_best_steps()}, f)
        export_torch_pth(self.best_model,
                         os.path.join(self.exp_dir, "best_model.pth"))
