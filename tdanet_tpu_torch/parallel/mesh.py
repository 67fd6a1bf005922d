"""Device meshes for data parallelism (counterpart of
``tdanet_tpu/parallel/mesh.py``).

The JAX package names its axes ``dp`` (batch) and ``tp`` (the separator's
channels) on a ``jax.sharding.Mesh`` and lets XLA insert the collectives.
Here a :class:`Mesh` is one of two things:

- a process mesh: ``torch.distributed`` is initialised, every rank drives
  one device and owns a contiguous slice of the global batch, and ``dp``
  is the world size. The train and eval steps (``system/trainer.py``)
  compute the function of one device over all rows: the batch-axis
  attention gathers every rank's rows, the dropout masks are the global
  batch's, the loss is the global one and the gradients are summed over
  ranks (``parallel/collectives.py``);
- a local mesh: one process splits the rows of a batch over an explicit
  list of devices (a device may repeat, so one card, or the CPU, can hold
  several replicas). Eval and serving separate every row as if alone, so
  each replica runs its rows with the model on its device (one copy a
  further device; a repeated device shares it).

Tensor parallelism is not ported: a mesh with ``tp`` above 1 raises
(ROADMAP A #10, "tp execution"). ``TDANET_TP_RULES`` and
:func:`param_shardings` keep the JAX package's layout table, as strings.
"""

from __future__ import annotations

import copy
import os
import re
import warnings
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

TP_NOT_PORTED = ("tensor parallelism (tp > 1) is not ported: ROADMAP A #10, "
                 "\"tp execution\"")


def _env_int(name):
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device=None):
    """Start this process's ``torch.distributed`` group. The arguments
    default to torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); ``coordinator_address`` is ``host:port``.
    Returns False, and starts nothing, on one process.

    The backend is ``TDANET_DIST_BACKEND`` from the environment, else
    NCCL for CUDA ranks and gloo for CPU ranks (``device``: the rank's
    device type or name; CUDA unless it says cpu). An NCCL group is made to
    run one all-reduce before this returns, so a group that cannot start
    raises here; nothing falls back to another backend or to one
    process."""
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if num_processes in (None, 1):
        return False
    if process_id is None:
        raise ValueError("initialize_distributed needs process_id (or RANK)")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not addr or not port:
            raise ValueError("initialize_distributed needs "
                             "coordinator_address (or MASTER_ADDR and "
                             "MASTER_PORT)")
        coordinator_address = f"{addr}:{port}"
    cpu = str(device or "cuda").startswith("cpu")
    backend = os.environ.get("TDANET_DIST_BACKEND") or (
        "gloo" if cpu else "nccl")
    if backend == "nccl":
        local = local_rank()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        probe = torch.ones(1, device=f"cuda:{local}")
        dist.all_reduce(probe)
        if probe.item() != num_processes:
            raise RuntimeError(f"NCCL all-reduce over {num_processes} ranks "
                               f"gave {probe.item()}")
    return True


def local_rank():
    """This process's index on its host (torchrun's ``LOCAL_RANK``), else
    its global rank, else 0."""
    v = _env_int("LOCAL_RANK")
    if v is None:
        v = dist.get_rank() if dist.is_initialized() else 0
    return v


@dataclass(frozen=True)
class Mesh:
    """``devices`` is this process's device list: the rank's one device in
    a process mesh, the dp replicas' devices (in row order) in a local
    one. ``group`` is the process group of a process mesh (None in a local
    mesh), ``rank`` the process's dp index."""

    devices: tuple
    shape: dict = field(default_factory=dict)
    group: Optional[object] = None
    rank: int = 0

    @property
    def dp(self):
        return self.shape["dp"]

    @property
    def device(self):
        """The first device: the rank's device in a process mesh."""
        return self.devices[0]

    @property
    def across_processes(self):
        return self.group is not None


def _device_list(devices):
    return tuple(torch.device(d) for d in devices)


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """A ``(dp, tp)`` mesh; ``dp * tp`` must equal the devices.

    With ``torch.distributed`` initialised, a process mesh over its world
    group: dp is the world size, each rank drives one device,
    ``devices`` (default ``cuda:LOCAL_RANK`` on an NCCL group, the CPU on
    gloo) naming the rank's own. Otherwise a local mesh over ``devices``
    (default: every visible CUDA device; a device may repeat); a dp above
    the visible devices without an explicit list raises."""
    if tp != 1:
        raise NotImplementedError(TP_NOT_PORTED)
    if dist.is_initialized():
        group = dist.group.WORLD
        n = dist.get_world_size(group)
        if devices is None:
            devices = [f"cuda:{local_rank()}"
                       if dist.get_backend(group) == "nccl" else "cpu"]
        devices = _device_list(devices)
        if len(devices) != tp:
            raise ValueError(f"a rank drives {tp} device(s) (tp), got "
                             f"{len(devices)}")
        if dp is None:
            dp = n // tp
        assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
        return Mesh(devices, {"dp": dp, "tp": tp}, group,
                    dist.get_rank(group))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        want = (dp or count) * tp
        if count == 0 or want > count:
            raise ValueError(
                f"dp({dp}) * tp({tp}) asks for more devices than the "
                f"{count} visible CUDA device(s); pass devices= (a device "
                f"may repeat) to place several replicas on one")
        devices = [f"cuda:{i}" for i in range(want)]
    devices = _device_list(devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    return Mesh(devices, {"dp": dp, "tp": tp})


# Param-path regex -> PartitionSpec axes for the TDANet family: the JAX
# package's table, unchanged. Paths are the dotted state-dict names. The
# 512-channel separator weights shard over 'tp'; the rest is replicated.
TDANET_TP_RULES = [
    # UConvBlock projection 128 -> 512: shard output channels
    (r"sm\.unet\.proj_1x1\.conv\.weight$", ("tp", None, None)),
    (r"sm\.unet\.proj_1x1\.conv\.bias$", ("tp",)),
    (r"sm\.unet\.proj_1x1\.norm\.(gamma|beta|weight|bias)$", ("tp",)),
    # depthwise pyramid: purely channel-parallel
    (r"sm\.unet\.spp_dw\.\d+\.conv\.weight$", ("tp", None, None)),
    (r"sm\.unet\.spp_dw\.\d+\.conv\.bias$", ("tp",)),
    (r"sm\.unet\.spp_dw\.\d+\.norm\.(gamma|beta|weight|bias)$", ("tp",)),
    # LA fusions: depthwise over 512 channels
    (r"sm\.unet\.(loc_glo_fus|last_layer)\.\d+\..*conv\.weight$",
     ("tp", None, None)),
    (r"sm\.unet\.(loc_glo_fus|last_layer)\.\d+\..*norm\.(gamma|beta)$",
     ("tp",)),
    # FFN: megatron-style, fc1 row-parallel, fc2 column-parallel
    (r"sm\.unet\.globalatt\.mlp\.fc1\.conv\.weight$", ("tp", None, None)),
    (r"sm\.unet\.globalatt\.mlp\.fc1\.norm\.(gamma|beta)$", ("tp",)),
    (r"sm\.unet\.globalatt\.mlp\.dwconv\.weight$", ("tp", None, None)),
    (r"sm\.unet\.globalatt\.mlp\.dwconv\.bias$", ("tp",)),
    (r"sm\.unet\.globalatt\.mlp\.fc2\.conv\.weight$", (None, "tp", None)),
    # MHA: shard the head/embed dim of the projections
    (r"sm\.unet\.globalatt\.attn\.attn\.in_proj_weight$", (None, "tp")),
    (r"sm\.unet\.globalatt\.attn\.attn\.out_proj\.weight$", ("tp", None)),
    (r"sm\.unet\.res_conv\.weight$", (None, "tp", None)),
]


def spec_str(axes) -> str:
    """A spec as ``str(jax.sharding.PartitionSpec(*axes))`` prints it."""
    return f"PartitionSpec{tuple(axes)!r}"


def _spec_for_path(path: str, rules) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return ()  # replicated


def param_shardings(params, mesh, rules=None, verbose=True):
    """``{name: spec string}`` for every parameter of ``params`` (a module,
    or a ``{dotted name: tensor or array}`` dict), as the JAX package's
    ``param_shardings`` lays them out over ``mesh`` (a :class:`Mesh`, or
    its ``{"dp": n, "tp": n}`` shape; tp may exceed 1 here, since no
    tensor is placed).

    A rule whose sharded axis does not divide the mesh axis is DROPPED
    (the weight is replicated instead); every such drop is reported in one
    warning, so a tp=4 request cannot silently degrade to tp=1."""
    rules = TDANET_TP_RULES if rules is None else rules
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    dropped, out = [], {}
    for path, node in params.items():
        dims = tuple(node.shape)
        spec = _spec_for_path(path, rules)
        axes = list(spec)
        for i, s in enumerate(axes):
            if s is not None:
                if i >= len(dims) or dims[i] % shape[s] != 0:
                    dropped.append((path, dims, spec_str(spec)))
                    axes = [None] * max(len(dims), 1)
                    break
        out[path] = spec_str(axes)
    if dropped and verbose:
        head = ", ".join(f"{p} {sh}" for p, sh, _ in dropped[:5])
        warnings.warn(
            f"param_shardings: {len(dropped)} matched sharding rule(s) "
            f"dropped to replication (axis does not divide the mesh): "
            f"{head}{' ...' if len(dropped) > 5 else ''}")
    return out


def batch_sharding(mesh: Mesh, batch_size: int):
    """The rows each dp index owns of a batch of ``batch_size``: a list of
    ``dp`` contiguous slices, in order (the leading batch axis over dp,
    as the JAX package's ``P("dp")``). ``batch_size`` must be a multiple
    of dp."""
    dp = mesh.dp
    n = batch_size // dp
    return [slice(i * n, (i + 1) * n) for i in range(dp)]


def replicated(mesh: Mesh, model):
    """The model on every dp replica's device of a local mesh, in row
    order: ``model`` itself where it already lives, one copy a further
    device (a repeated device shares its copy)."""
    if mesh.shape["tp"] != 1:
        raise NotImplementedError(TP_NOT_PORTED)
    home = next(model.parameters()).device
    by_device = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = model if d == home else \
                copy.deepcopy(model).to(d)
    return [by_device[d] for d in mesh.devices]


def dp_batch_setup(mesh: Mesh, batch_size: int, model, what="batch_size"):
    """Shared set-up for dp-split eval and serving on a local mesh: the
    batch must be a multiple of the mesh's dp axis. Returns
    ``(row slices, replicas)`` (:func:`batch_sharding`,
    :func:`replicated`), so that every caller splits rows alike."""
    check_dp_batch(mesh, batch_size, what)
    return batch_sharding(mesh, batch_size), replicated(mesh, model)


def check_dp_batch(mesh: Mesh, batch_size: int, what="batch_size"):
    """:func:`dp_batch_setup`'s checks alone: a local mesh, and a batch
    that is a multiple of its dp axis."""
    if mesh.across_processes:
        raise ValueError(
            "eval and serving split rows over the devices of one process: "
            "make_mesh(dp, devices=[...]) outside a process group")
    dp = mesh.dp
    if batch_size % dp:
        raise ValueError(
            f"{what} ({batch_size}) must be a multiple of the mesh dp "
            f"axis ({dp}) for sharded serving")


def shard_params(params, mesh, rules=None):
    """Placing parameters over a tp axis is not ported."""
    raise NotImplementedError(TP_NOT_PORTED)
