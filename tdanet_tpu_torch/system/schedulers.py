"""Host-side learning-rate schedulers (counterpart of
``tdanet_tpu/system/schedulers.py``, the same classes).

Schedulers run on the host between steps and the trainer writes the new
learning rate into the optimizer (``optimizers.set_learning_rate``). State
is a plain dict, saved with the checkpoint's extras.
"""

from __future__ import annotations


class BaseScheduler:
    """Step-wise scheduler protocol (schedulers.py:6-56)."""

    def __init__(self):
        self.step_num = 0

    def _get_lr(self):
        raise NotImplementedError

    def step(self, metrics=None, epoch=None):
        self.step_num += 1
        return self._get_lr()

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def load_state_dict(self, state):
        self.__dict__.update(state)

    def as_list(self, start=0, stop=100_000):
        saved = self.step_num
        out = []
        for _ in range(start, stop):
            self.step_num += 1
            out.append(self._get_lr())
        self.step_num = saved
        return out


class DPTNetScheduler(BaseScheduler):
    """Noam warmup then 0.98^(epoch//2) decay (schedulers.py:58-112)."""

    def __init__(self, steps_per_epoch, d_model, warmup_steps=4000,
                 noam_scale=1.0, exp_max=0.0004, exp_base=0.98):
        super().__init__()
        self.noam_scale = noam_scale
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.exp_max = exp_max
        self.exp_base = exp_base
        self.steps_per_epoch = steps_per_epoch
        self.epoch = 0

    def _get_lr(self):
        if self.step_num % self.steps_per_epoch == 0:
            self.epoch += 1
        if self.step_num > self.warmup_steps:
            return self.exp_max * (self.exp_base ** ((self.epoch - 1) // 2))
        return (self.noam_scale * self.d_model ** -0.5
                * min(self.step_num ** -0.5,
                      self.step_num * self.warmup_steps ** -1.5))


class ReduceLROnPlateau:
    """Epoch scheduler parity with torch.optim.lr_scheduler.ReduceLROnPlateau
    as configured by the reference (patience 15, factor 0.5;
    configs/tdanet.yml:47-52)."""

    def __init__(self, lr, mode="min", factor=0.5, patience=15,
                 threshold=1e-4, threshold_mode="rel", cooldown=0,
                 min_lr=0.0, **unused):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, current):
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            eps = self.threshold * abs(self.best)
        else:
            eps = self.threshold
        if self.mode == "min":
            return current < self.best - eps
        return current > self.best + eps

    def step(self, metrics):
        current = float(metrics)
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, state):
        self.__dict__.update(state)


def make_scheduler(sche_name, lr, steps_per_epoch=None, d_model=None,
                   **sche_config):
    """Name-driven scheduler factory (audio_train.py:75-89)."""
    name = str(sche_name).lower()
    if name == "reducelronplateau":
        return ReduceLROnPlateau(lr, **sche_config)
    if name == "dptnetscheduler":
        return DPTNetScheduler(steps_per_epoch=steps_per_epoch,
                               d_model=d_model, **sche_config)
    if name in ("none", "constant"):
        return None
    raise ValueError(f"Unknown scheduler {sche_name!r}")
