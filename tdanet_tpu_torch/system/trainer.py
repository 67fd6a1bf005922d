"""Train and eval steps, on one device or over a data-parallel mesh
(counterpart of ``tdanet_tpu/system/trainer.py``).

A step is forward, loss, backward, the optimizer's global-norm clip and
its update, eagerly. Where the JAX package passes ``params`` and an
optax state, the port's state holds the model (whose parameters are the
params) and the torch.optim optimizer built over them.

Under a process mesh (``parallel.make_mesh`` in a ``torch.distributed``
group) every rank runs the step on its slice of the global batch, and the
ranks together compute the JAX package's dp step, which is one device's
step over all rows: the model's forward gets the group (``dp_group=``:
the batch-axis attention attends over every rank's rows and the dropout
masks are the global batch's), the loss is the global batch's mean
(``PITLossWrapper(dp_group=)``), and after the backward, with the
parameters that the loss did not reach zero-filled, every gradient is
summed over ranks by one all-reduce of one flat buffer in the
parameters' order, before the global-norm clip. No
``DistributedDataParallel``: its hooks fire per use of a parameter, and
the shared UConvBlock is used 16 times a forward (and again in the
checkpointed recomputation), while the coarsest LA fusion's parameters get
no gradient at all; one reduction after the backward sees each gradient
once, whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tdanet_tpu_torch.models.base import load_jax_params
from tdanet_tpu_torch.parallel import collectives


@dataclass
class TrainState:
    model: torch.nn.Module           # the parameters
    optimizer: torch.optim.Optimizer
    step: int = 0


def dp_group_of(mesh):
    """The process group of a process mesh; None for no mesh or a local
    mesh of one replica. A local mesh of several replicas raises: a train
    or eval step over a mesh is one process a rank
    (``python -m tdanet_tpu_torch.launch_multihost`` or torchrun)."""
    if mesh is None:
        return None
    if mesh.shape["tp"] != 1:
        from tdanet_tpu_torch.parallel.mesh import TP_NOT_PORTED
        raise NotImplementedError(TP_NOT_PORTED)
    if mesh.group is not None:
        return mesh.group
    if mesh.dp == 1:
        return None
    raise ValueError(
        f"a train or eval step over dp={mesh.dp} runs one process a rank: "
        f"start the ranks with python -m tdanet_tpu_torch.launch_multihost "
        f"(or torchrun) and make the mesh inside the process group")


def _dp_kwargs(group):
    """The forward's and the loss's keyword for a process group: none
    without one, so that a callable without ``dp_group`` runs alone."""
    return {} if group is None else {"dp_group": group}


def create_train_state(model, optimizer, generator_or_params, mesh=None,
                       device=None):
    """Initialise the model's parameters from a (CPU) ``torch.Generator``,
    or load a flat ``{dotted key: array}`` dict, move the model to
    ``device`` (default: the mesh's device for this rank) when given, then
    build the optimizer over its parameters. Under a process mesh every
    rank then takes rank 0's parameters and buffers (broadcast)."""
    group = dp_group_of(mesh)
    if isinstance(generator_or_params, torch.Generator):
        model.cpu().reset_parameters(generator_or_params)
    elif generator_or_params is not None:
        load_jax_params(model, generator_or_params)
    if device is None and mesh is not None:
        device = mesh.device
    if device is not None:
        model.to(device)
    collectives.broadcast_parameters(model, group)
    return TrainState(model, optimizer.init(model.parameters()), 0)


def make_train_step(model, loss_fn, optimizer, mesh=None,
                    compute_dtype=None):
    """Returns ``step(state, mixtures, targets, generator) -> (state,
    loss)``: mixtures (B, T), targets (B, n_src, T) (under a process mesh,
    this rank's rows of the global batch), dropout masks from
    ``generator`` (the same seed on every rank). ``model`` is the callable
    of the forward (the state's model, or a wrapper of it; under a mesh it
    takes ``dp_group=``). A parameter that the loss does not reach gets a
    zero gradient, as under ``jax.grad``, so every optimizer treats every
    parameter alike. The loss, the global batch's on every rank, comes
    back on the device."""
    group = dp_group_of(mesh)
    dp = _dp_kwargs(group)

    def step(state: TrainState, mixtures, targets, generator):
        state.optimizer.zero_grad(set_to_none=True)
        est = model(mixtures, training=True, generator=generator,
                    compute_dtype=compute_dtype, **dp)
        loss = loss_fn(est, targets, **dp)
        loss.backward()
        params = [p for p in state.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        collectives.sum_gradients(params, group)
        optimizer.clip_([p.grad for p in params])
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(model, loss_fn, mesh=None, compute_dtype=None):
    """Returns ``step(mixtures, targets) -> loss`` without gradients; under
    a process mesh the global batch's loss, from this rank's rows."""
    dp = _dp_kwargs(dp_group_of(mesh))

    @torch.no_grad()
    def step(mixtures, targets):
        est = model(mixtures, training=False, compute_dtype=compute_dtype,
                    **dp)
        return loss_fn(est, targets, **dp)

    return step


def make_forward(model, mesh=None, compute_dtype=None):
    """Returns ``forward(mixtures) -> estimates`` without gradients; under
    a process mesh this rank's rows of the global batch's forward."""
    dp = _dp_kwargs(dp_group_of(mesh))

    @torch.no_grad()
    def forward(mixtures):
        return model(mixtures, training=False, compute_dtype=compute_dtype,
                     **dp)

    return forward
