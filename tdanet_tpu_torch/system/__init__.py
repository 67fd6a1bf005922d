"""Training runtime: optimizers, schedulers, train and eval steps,
checkpoints and the config-driven trainer (counterpart of
``tdanet_tpu/system``)."""

from tdanet_tpu_torch.system.optimizers import (  # noqa: F401
    get_learning_rate, make_optimizer, register_optimizer, set_learning_rate)
from tdanet_tpu_torch.system.schedulers import (  # noqa: F401
    BaseScheduler, DPTNetScheduler, ReduceLROnPlateau, make_scheduler)
from tdanet_tpu_torch.system.trainer import (  # noqa: F401
    TrainState, create_train_state, make_eval_step, make_forward,
    make_train_step)

__all__ = [
    "get_learning_rate", "make_optimizer", "register_optimizer",
    "set_learning_rate", "BaseScheduler", "DPTNetScheduler",
    "ReduceLROnPlateau", "make_scheduler", "TrainState",
    "create_train_state", "make_eval_step", "make_forward",
    "make_train_step", "AudioTrainer", "AudioLightningModule",
]


def __getattr__(name):
    # AudioTrainer pulls in the data layer; AudioLightningModule is the
    # reference's name for it
    if name in ("AudioTrainer", "AudioLightningModule"):
        from tdanet_tpu_torch.system.training_loop import AudioTrainer
        return AudioTrainer
    raise AttributeError(name)
