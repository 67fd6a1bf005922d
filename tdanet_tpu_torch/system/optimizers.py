"""Optimizer factory over ``torch.optim`` (counterpart of
``tdanet_tpu/system/optimizers.py``, which builds optax transformations).

``make_optimizer(name, lr=..., grad_clip=..., **kw)`` resolves a name
(case-insensitive) to an :class:`Optimizer`: a factory whose ``init``
builds the ``torch.optim`` optimizer over a model's parameters, and the
global-norm clip that goes before its step. Only names whose
``torch.optim`` class makes the JAX package's optax update are here
(checked against optax in ``tests/test_torch_train.py``): adam (decoupled
weight decay when ``weight_decay > 0``, as ``optax.adamw``), adamw, sgd
(momentum, nesterov, coupled weight decay), adadelta, adamax. The JAX
package's other names raise: their torch.optim namesake computes another
update, or the JAX package maps them to an analog (ROADMAP lists them).
Host-side schedulers set the learning rate between steps
(:func:`set_learning_rate`).
"""

from __future__ import annotations

import torch


def _adam(params, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8, **kw):
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)


def _adamw(params, lr, weight_decay=1e-2, betas=(0.9, 0.999), eps=1e-8,
           **kw):
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _sgd(params, lr, momentum=0.0, weight_decay=0.0, nesterov=False, **kw):
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           weight_decay=weight_decay, nesterov=nesterov)


_FACTORIES = {
    "adam": _adam,
    "adamw": _adamw,
    "sgd": _sgd,
    # optax.adadelta(lr) and optax.adamax(lr) with optax's defaults, which
    # are torch's
    "adadelta": lambda params, lr, **kw: torch.optim.Adadelta(params, lr=lr),
    "adamax": lambda params, lr, **kw: torch.optim.Adamax(params, lr=lr),
}

#: The JAX package's names without a torch.optim class that makes the same
#: update (ROADMAP A5): the namesake differs (eps placement, a momentum
#: schedule, a rectification term) or torch.optim has none, or the JAX
#: package maps the name to an analog of another optimizer.
NOT_PORTED = (
    "rmsprop", "adagrad", "radam", "nadam", "nadamw", "sgdw", "asgd",
    "adamaxw", "lamb", "lars", "novograd", "yogi", "adabelief", "adabound",
    "fromage", "sm3", "adafactor", "lion", "diffgrad", "accsgd", "qhadam",
    "qhm", "pid", "adamod", "ranger", "rangerqh", "rangerva")

_CUSTOM = {}


def register_optimizer(name: str, factory):
    """Register ``factory(params, lr, **kw) -> torch.optim.Optimizer``."""
    key = name.lower()
    if key in _FACTORIES or key in _CUSTOM:
        raise ValueError(f"Optimizer {name} already exists.")
    _CUSTOM[key] = factory


def get(identifier):
    if callable(identifier):
        return identifier
    key = str(identifier).lower()
    f = {**_FACTORIES, **_CUSTOM}.get(key)
    if f is None:
        if key in NOT_PORTED:
            raise ValueError(
                f"optimizer {identifier!r} is not ported: no torch.optim "
                "class makes the JAX package's update for it")
        raise ValueError(f"Could not interpret optimizer: {identifier}")
    return f


def clip_by_global_norm_(grads, max_norm):
    """optax.clip_by_global_norm in place: when the global norm
    sqrt(sum g^2) is at least ``max_norm`` every gradient becomes
    g / norm * max_norm (no 1e-6 is added to the norm, unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns the norm, on the device."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """A named optimizer with its learning rate, options and global-norm
    clip. ``init(params)`` builds the torch.optim optimizer;
    ``clip_(grads)`` clips in place when a clip was given."""

    def __init__(self, factory, lr, grad_clip=None, **kwargs):
        self.factory, self.lr, self.grad_clip = factory, lr, grad_clip
        self.kwargs = kwargs

    def init(self, params):
        return self.factory(list(params), lr=self.lr, **self.kwargs)

    def clip_(self, grads):
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip)


def make_optimizer(optim_name="adam", lr=1e-3, grad_clip=None,
                   **kwargs) -> Optimizer:
    """The optimizer ``optim_name`` (case-insensitive) with an optional
    global-norm clip before its step."""
    return Optimizer(get(optim_name), lr, grad_clip, **kwargs)


def set_learning_rate(opt_state, lr):
    """Set the learning rate of every parameter group of a torch.optim
    optimizer; returns it."""
    for group in opt_state.param_groups:
        group["lr"] = float(lr)
    return opt_state


def get_learning_rate(opt_state):
    return opt_state.param_groups[0]["lr"]
