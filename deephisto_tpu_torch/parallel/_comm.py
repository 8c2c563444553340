"""The collectives the parallel paths call, those that carry a gradient as
``torch.autograd.Function`` s (the port's own module: under ``shard_map``
JAX transposes ``psum`` and ``ppermute`` itself).

* :func:`all_reduce_sum`: a sum over a group whose backward is the sum of
  the gradient over the group (cross-rank BatchNorm statistics);
* :func:`copy_to_group` and :func:`reduce_from_group`: Megatron's pair
  around a tensor-parallel MLP, identity forward with an all-reduce
  backward, and an all-reduce forward with an identity backward;
* :func:`shift`: the pipeline's stage-to-stage hop, ``lax.ppermute`` over
  an open chain: rank i of the group sends to i + 1, the first receives
  zeros; the backward sends the gradient the other way;
* :func:`all_reduce_`, :func:`average_gradients` (data parallelism's
  one reduce of the gradients), :func:`halo_from_next` (the fcn bands' halo
  exchange, the reverse hop) and :func:`gather_rows`, without a gradient.

Every collective is NCCL's on a machine with a card a rank. Where ranks
share one card they run over gloo (NCCL refuses two ranks on a device).
Gloo's all-reduce, broadcast and all-gathers take CUDA tensors; its send and receive
take a tensor's pointer as host memory, so the hops stage a CUDA
tensor through the host under gloo, an explicit branch on the group's
backend (:func:`host_staged`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def host_staged(group, t: torch.Tensor) -> bool:
    """True where a point-to-point copy of ``t`` over ``group`` goes through
    host memory: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no gradient); returns ``t``."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def average_gradients(params, group) -> None:
    """Average the parameters' gradients over ``group`` in place: one
    all-reduce of them flattened (a parameter without a gradient is
    skipped; every rank must hold the same set)."""
    if group_size(group) == 1:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_(_flatten_dense_tensors(grads), group).div_(group_size(group))
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks; the gradient of each rank's input is the
    gradient summed over the ranks."""
    return _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer. Identity; the
    gradient is summed over the group."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the partial outputs of a row-parallel layer summed over
    the group; the gradient passes as it is."""
    return _ReduceFromGroup.apply(x, group)


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """What the group's rank i − ``offset`` holds, after sending ``x`` to rank
    i + ``offset``; zeros where there is no rank i − ``offset``."""
    ranks = dist.get_process_group_ranks(group)
    i, n = ranks.index(dist.get_rank()), len(ranks)
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    staged = host_staged(group, x)
    send = x.detach().cpu() if staged else x.detach().contiguous()
    recv = torch.zeros_like(send) if staged else out
    ops = []
    if 0 <= i + offset < n:
        ops.append(dist.P2POp(dist.isend, send, ranks[i + offset], group))
    if 0 <= i - offset < n:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[i - offset], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if staged:
        out.copy_(recv)
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """The pipeline hop: rank i of ``group`` gets rank i − 1's ``x`` (rank 0
    zeros), and the gradient of ``x`` is what rank i + 1 holds of the
    result's gradient (the last rank's is zero)."""
    return _Shift.apply(x, group)


def halo_from_next(x: torch.Tensor, group) -> torch.Tensor:
    """What the group's next rank holds of ``x`` (zeros on the last rank),
    after sending ``x`` to the previous one: a band's halo rows (no
    gradient)."""
    return _shift(x, group, -1)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ranks' ``x`` stacked along the leading axis in rank order,
    on every rank (``all_gather_into_tensor``, which gloo and NCCL both take
    on the card)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((group_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ranks' ``x`` concatenated along ``dim`` in rank order."""
    return gather_rows(x.movedim(dim, 0), group).movedim(0, dim).contiguous()
