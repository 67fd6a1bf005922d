"""Train and eval steps on one device (counterpart of
``tdanet_tpu/system/trainer.py``).

A step is forward, loss, backward, the optimizer's global-norm clip and
its update, eagerly. Where the JAX package passes ``params`` and an
optax state, the port's state holds the model (whose parameters are the
params) and the torch.optim optimizer built over them. The mesh argument
stays in the signatures for data parallelism (ROADMAP A7); only
``mesh=None`` runs here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tdanet_tpu_torch.models.base import load_jax_params


@dataclass
class TrainState:
    model: torch.nn.Module           # the parameters
    optimizer: torch.optim.Optimizer
    step: int = 0


def _single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training is not ported yet (ROADMAP A7)")


def create_train_state(model, optimizer, generator_or_params, mesh=None,
                       device=None):
    """Initialise the model's parameters from a (CPU) ``torch.Generator``,
    or load a flat ``{dotted key: array}`` dict, move the model to
    ``device`` when given, then build the optimizer over its
    parameters."""
    _single_device(mesh)
    if isinstance(generator_or_params, torch.Generator):
        model.cpu().reset_parameters(generator_or_params)
    elif generator_or_params is not None:
        load_jax_params(model, generator_or_params)
    if device is not None:
        model.to(device)
    return TrainState(model, optimizer.init(model.parameters()), 0)


def make_train_step(model, loss_fn, optimizer, mesh=None,
                    compute_dtype=None):
    """Returns ``step(state, mixtures, targets, generator) -> (state,
    loss)``: mixtures (B, T), targets (B, n_src, T), dropout masks from
    ``generator``. ``model`` is the callable of the forward (the state's
    model, or a wrapper of it). A parameter that the loss does not reach
    gets a zero gradient, as under ``jax.grad``, so every optimizer treats
    every parameter alike. The loss comes back on the device."""
    _single_device(mesh)

    def step(state: TrainState, mixtures, targets, generator):
        state.optimizer.zero_grad(set_to_none=True)
        est = model(mixtures, training=True, generator=generator,
                    compute_dtype=compute_dtype)
        loss = loss_fn(est, targets)
        loss.backward()
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.clip_([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(model, loss_fn, mesh=None, compute_dtype=None):
    """Returns ``step(mixtures, targets) -> loss`` without gradients."""
    _single_device(mesh)

    @torch.no_grad()
    def step(mixtures, targets):
        est = model(mixtures, training=False, compute_dtype=compute_dtype)
        return loss_fn(est, targets)

    return step


def make_forward(model, mesh=None, compute_dtype=None):
    """Returns ``forward(mixtures) -> estimates`` without gradients."""
    _single_device(mesh)

    @torch.no_grad()
    def forward(mixtures):
        return model(mixtures, training=False, compute_dtype=compute_dtype)

    return forward
