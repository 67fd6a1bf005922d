"""The collectives of the data-parallel step: each rank holds a
contiguous slice of the global batch, and these make its forward, loss and
gradients those of one device over all rows.

- :func:`gather_rows`: every rank's rows of a tensor, in rank order; its
  backward sums the gradient over ranks and keeps the rank's rows;
- :func:`global_sum`: a value summed over ranks whose gradient passes
  to each rank's own term unchanged;
- :func:`global_shape` / :func:`rank_rows`: the global batch's draw of a
  random tensor, of which a rank keeps its own rows, so the masks of a
  2-rank step are the one-process step's by construction;
- :func:`sum_gradients` and :func:`broadcast_parameters`.

Every collective here is an all-reduce or a broadcast, which gloo runs on
CPU and CUDA tensors and NCCL on CUDA tensors: a gather is the all-reduce
of a zero buffer that holds the rank's rows in its slot (a sum with zeros
is exact). ``group`` None means one process: every function is then the
identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank_and_world(group):
    """(rank, world size) in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _all_sum(x, group):
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, world = rank_and_world(group)
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        out = x.new_zeros((world * x.shape[0],) + tuple(x.shape[1:]))
        out[rank * x.shape[0]:(rank + 1) * x.shape[0]] = x
        return _all_sum(out, group)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_sum(grad.contiguous().clone(), ctx.group)
        n = ctx.n
        return grad[ctx.rank * n:(ctx.rank + 1) * n], None


def gather_rows(x, group):
    """(B_loc, ...) on every rank -> (world * B_loc, ...), the ranks' rows
    in rank order; differentiable (the backward all-reduces the gradient
    and keeps this rank's rows). Every rank must give the same shape."""
    if group is None:
        return x
    return _GatherRows.apply(x, group)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x, group):
    """The sum of ``x`` over ranks (the same bits on every rank). Its
    gradient is passed to this rank's ``x`` unchanged: a loss written as
    ``global_sum(this rank's term)`` backpropagates each rank's term on its
    rank, and :func:`sum_gradients` adds them up."""
    if group is None:
        return x
    return _GlobalSum.apply(x, group)


def all_sum(x, group):
    """The sum of ``x`` over ranks, outside autograd (counts, flags)."""
    if group is None:
        return x
    return _all_sum(x.detach().clone(), group)


def all_max(value: float, group) -> float:
    """The largest of a host-side float over ranks."""
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=_collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def rank_rows(t, group, axis=0):
    """This rank's rows of a global-batch tensor along ``axis``."""
    rank, world = rank_and_world(group)
    if world == 1:
        return t
    n = t.shape[axis] // world
    return t.narrow(axis, rank * n, n)


def global_shape(shape, group, axis=0):
    """``shape`` with its ``axis`` extent multiplied by the world size:
    the global batch's shape of this rank's tensor."""
    _, world = rank_and_world(group)
    shape = list(shape)
    shape[axis] *= world
    return tuple(shape)


def sum_gradients(params, group):
    """Sum every parameter's gradient over ranks, in place, with one
    all-reduce of one flat buffer in the parameters' order: every rank
    gets the same bits. Every gradient must be set (the caller zero-fills
    the ones the loss did not reach, so every rank's buffer has the same
    layout)."""
    if group is None:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_sum(flat, group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def broadcast_parameters(module, group, src=0):
    """Every parameter and buffer of ``module`` from the group's rank
    ``src``, in place (one broadcast each)."""
    if group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def any_rank(flags, group):
    """OR of each host-side flag over ranks (one all-reduce)."""
    if group is None:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([1 if f else 0 for f in flags], dtype=torch.int64,
                     device=_collective_device(group))
    _all_sum(t, group)
    return tuple(bool(v) for v in t.tolist())


def _collective_device(group):
    """Where a host-side value goes for a collective: the card under NCCL,
    the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(group):
    if group is not None:
        dist.barrier(group=group)
