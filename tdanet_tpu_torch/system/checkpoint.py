"""Checkpoints: the top-k by validation loss and the last, and the
reference ``.pth`` export (counterpart of ``tdanet_tpu/system/checkpoint.py``,
with ``torch.save`` in place of orbax).

A checkpoint holds the model's state dict, the optimizer's, the train
step and the validation loss; host-side extras (epoch, scheduler state)
go to ``extras.json`` beside them, as in the JAX package. Every file is
written to a temporary name and renamed, so a reader sees all of a file
or none of it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from tdanet_tpu_torch.system.trainer import TrainState


def _save_atomic(obj, path):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Top-k-by-val-loss (lowest first; at equal loss the earlier step) and
    always the last, under ``exp_dir/best`` and ``exp_dir/last``."""

    def __init__(self, exp_dir: str, top_k: int = 3):
        self.exp_dir = os.path.abspath(exp_dir)
        self.top_k = top_k
        self._dirs = {k: os.path.join(self.exp_dir, k)
                      for k in ("best", "last")}
        for d in self._dirs.values():
            os.makedirs(d, exist_ok=True)

    def _path(self, kind, step):
        return os.path.join(self._dirs[kind], f"{int(step)}.pt")

    def _steps(self, kind):
        return sorted(int(f[:-3]) for f in os.listdir(self._dirs[kind])
                      if f.endswith(".pt"))

    def _best_metrics(self) -> Dict[int, float]:
        path = os.path.join(self._dirs["best"], "metrics.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return {int(k): v for k, v in json.load(f).items()}

    def save(self, step: int, state: TrainState, val_loss: float,
             extras: Optional[Dict[str, Any]] = None):
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": state.step, "val_loss": float(val_loss)}
        for old in self._steps("last"):
            os.remove(self._path("last", old))
        _save_atomic(payload, self._path("last", step))
        metrics = self._best_metrics()
        metrics[int(step)] = float(val_loss)
        keep = sorted(metrics, key=lambda s: (metrics[s], s))[:self.top_k]
        if int(step) in keep:
            _save_atomic(payload, self._path("best", step))
        for s in self._steps("best"):
            if s not in keep:
                os.remove(self._path("best", s))
        with open(os.path.join(self._dirs["best"], "metrics.json"), "w") as f:
            json.dump({str(s): metrics[s] for s in sorted(keep)}, f)
        if extras is not None:
            with open(os.path.join(self.exp_dir, "extras.json"), "w") as f:
                json.dump(_jsonable(extras), f, indent=2)

    def wait(self):
        """Saves are synchronous; kept for the JAX package's interface."""

    def best_step(self):
        metrics = self._best_metrics()
        if not metrics:
            return None
        return min(metrics, key=lambda s: (metrics[s], s))

    def all_best_steps(self):
        return self._steps("best")

    def _restore(self, kind, step, template: TrainState):
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.exp_dir}")
        device = next(template.model.parameters()).device
        payload = torch.load(self._path(kind, step), map_location=device,
                             weights_only=True)
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        template.step = payload["step"]
        return template, step

    def restore_last(self, template: TrainState) -> tuple[TrainState, int]:
        """Load the last checkpoint into ``template``'s model and
        optimizer; returns (template, its step)."""
        steps = self._steps("last")
        return self._restore("last", steps[-1] if steps else None, template)

    def restore_best(self, template: TrainState) -> tuple[TrainState, int]:
        return self._restore("best", self.best_step(), template)

    def load_extras(self) -> Dict[str, Any]:
        path = os.path.join(self.exp_dir, "extras.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def close(self):
        """Nothing is held open; kept for the JAX package's interface."""


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def export_torch_pth(model, path: str):
    """Write ``model.serialize()``, the reference schema ``{model_name,
    state_dict, model_args, infos}``, to ``path`` (the best_model.pth that
    ``from_pretrain`` of either package reads)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _save_atomic(model.serialize(), path)
    return path
