"""Tensor-parallel (Megatron) MLPs for the ViT family, a port of
``deephisto_tpu/parallel/tensor.py``.

The JAX package annotates the parameters' shardings over the ``model``
axis and GSPMD inserts the collectives. Here each rank holds its shards and
the collectives are written out (``_comm.py``):

* ``fc1`` column-parallel: its (4D, D) weight split on the output features,
  its bias likewise; the input passes through Megatron's f (identity
  forward, the gradient summed over the ``model`` group), so each rank
  computes its 4D/m slice of the hidden layer with no communication;
* ``fc2`` row-parallel: its (D, 4D) weight split on the input features;
  the partial products are summed by one all-reduce (Megatron's g) and the
  bias, replicated, is added once, after it.

Attention stays replicated: K3, K4 and K5 run on all heads on every rank
(the fused qkv projection's output axis is laid out (3, heads, head_dim),
so a contiguous split crosses q/k/v). Every parameter outside the MLPs is
replicated, and its gradient is the same on every rank of the ``model``
group (f sums the MLP input's gradient) up to the order of its sums: on a
card the conv stem's weight gradient (cuDNN) accumulates in no fixed order,
so two ranks' copies differ in the last bits. The train steps therefore
broadcast the replicated parameters' gradients from the group's first rank
(:func:`broadcast_replicated_gradients`, one broadcast a step), and the
replicas, their optimizer moments with them, stay bit-equal. The
optimizer's moments of a shard live with it. Composes with data
parallelism on the mesh's ``data`` axis (``make_steps(model, mesh)``) and
with the BatchNorm conv stem.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.resnet import cast_param
from ..models.vit import GatedBlock, _Dense
from ._comm import copy_to_group, gather_dim, reduce_from_group
from .mesh import MODEL_AXIS, axis_size


def vit_tp_spec(name: str, x: torch.Tensor) -> tuple:
    """The sharding of one ViT parameter under MLP tensor parallelism, one
    entry a dimension of torch's layout (a Linear weight is (out, in)):
    ``MODEL_AXIS`` where the dimension is split, None where it is not; ()
    for a replicated parameter."""
    parts = name.split(".")
    if "fc1" in parts:
        return (MODEL_AXIS, None) if x.dim() == 2 else (MODEL_AXIS,)
    if "fc2" in parts:
        return (None, MODEL_AXIS) if x.dim() == 2 else ()
    return ()


def vit_tp_shardings(params, mesh) -> dict:
    """``{name: vit_tp_spec(name, tensor)}`` over a module's parameters or a
    state dict."""
    if MODEL_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh must have a {MODEL_AXIS!r} axis")
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {n: vit_tp_spec(n, x) for n, x in items}


def _piece(x: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    per = x.shape[dim] // count
    return x.narrow(dim, index * per, per).clone()


class ColumnParallelDense(_Dense):
    """``fc1``'s shard: rows ``index``·h/m … of the weight and bias; the
    input enters through Megatron's f."""

    def __init__(self, dense: nn.Linear, group, index: int, count: int):
        super().__init__(dense.in_features, dense.out_features // count,
                         device=dense.weight.device)
        self.group = group
        with torch.no_grad():
            self.weight.copy_(_piece(dense.weight, 0, index, count))
            self.bias.copy_(_piece(dense.bias, 0, index, count))

    def forward(self, x):
        return super().forward(copy_to_group(x, self.group))


class RowParallelDense(_Dense):
    """``fc2``'s shard: columns ``index``·h/m … of the weight; the partial
    products summed over the group (Megatron's g), then the whole bias."""

    def __init__(self, dense: nn.Linear, group, index: int, count: int):
        super().__init__(dense.in_features // count, dense.out_features,
                         device=dense.weight.device)
        self.group = group
        with torch.no_grad():
            self.weight.copy_(_piece(dense.weight, 1, index, count))
            self.bias.copy_(dense.bias)

    def forward(self, x):
        y = reduce_from_group(F.linear(x, cast_param(self, "weight", x.dtype)), self.group)
        return y + cast_param(self, "bias", x.dtype)


def _mlp_blocks(model: nn.Module) -> list:
    return [m for m in model.modules()
            if isinstance(getattr(m, "fc1", None), nn.Linear)
            and isinstance(getattr(m, "fc2", None), nn.Linear)]


def place_vit_tensor_parallel(state, mesh):
    """Shard a ViT train state's MLPs over the mesh's ``model`` axis, in
    place: each block's ``fc1``/``fc2`` become this rank's
    :class:`ColumnParallelDense`/:class:`RowParallelDense`, and the
    optimizer is rebuilt over the new parameters with its hyperparameters,
    a shard's moments cut from the whole parameter's. Every rank of the
    mesh calls it on the same state. Refuses a model with no ``fc1`` (the
    ViT family only) and a hidden width the ``model`` axis does not divide.
    Returns the state; train it with ``make_steps(model, mesh)``."""
    m = axis_size(mesh, MODEL_AXIS)
    model, opt = state.model, state.optimizer
    blocks = _mlp_blocks(model)
    if not blocks:
        raise ValueError(
            "the model has no fc1 layers — tensor parallelism supports the "
            "ViT family (models/vit.py) only"
        )
    if any(isinstance(b, GatedBlock) for b in blocks):
        raise ValueError("tensor parallelism shards the GELU MLP; a gated block's fc1 packs "
                         "the gate and the value, which a cut of its rows would split apart")
    hidden = [b.fc1.out_features for b in blocks]
    if any(h % m for h in hidden):
        raise ValueError(f"MLP hidden width {hidden[0]} not divisible by model axis {m}")
    index, group = mesh.get_local_rank(MODEL_AXIS), mesh.get_group(MODEL_AXIS)

    moments = {}  # new parameter -> its cut of the whole parameter's optimizer state
    for b in blocks:
        for name, cls, dim in (("fc1", ColumnParallelDense, 0), ("fc2", RowParallelDense, 1)):
            old = getattr(b, name)
            new = cls(old, group, index, m)
            for p_old, p_new, d in ((old.weight, new.weight, dim),
                                    (old.bias, new.bias, 0 if name == "fc1" else None)):
                st = opt.state.get(p_old)
                if st:
                    moments[p_new] = {k: (_piece(v, d, index, m) if d is not None and v.dim() > 0
                                          else v.clone()) for k, v in st.items()}
            setattr(b, name, new)
    group0 = opt.param_groups[0]
    new_opt = type(opt)(list(model.parameters()), **opt.defaults)
    new_opt.param_groups[0].update({k: v for k, v in group0.items() if k != "params"})
    for p in model.parameters():
        st = moments.get(p, opt.state.get(p))
        if st:
            new_opt.state[p] = st
    state.optimizer = new_opt
    return state


def replicated_parameters(model: nn.Module) -> list:
    """The parameters every rank of the ``model`` group holds whole: all but
    the shards of :class:`ColumnParallelDense` and :class:`RowParallelDense`
    (whose bias is whole)."""
    sharded = set()
    for m in model.modules():
        if isinstance(m, ColumnParallelDense):
            sharded |= {id(m.weight), id(m.bias)}
        elif isinstance(m, RowParallelDense):
            sharded.add(id(m.weight))
    return [p for p in model.parameters() if id(p) not in sharded]


def broadcast_replicated_gradients(model: nn.Module, group) -> None:
    """Give every rank of ``group`` the first rank's gradients of the
    replicated parameters, in place: one broadcast of them flattened (a
    parameter without a gradient is skipped; every rank holds the same
    set)."""
    if dist.get_world_size(group) == 1:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [p.grad for p in replicated_parameters(model) if p.grad is not None]
    flat = _flatten_dense_tensors(grads)
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


def vit_tp_state_dict(model: nn.Module, mesh) -> dict:
    """The canonical (unsharded) state dict of a tensor-parallel ViT, the
    shards gathered over the ``model`` group, on every rank: load it into a
    fresh ViT for ``save_model`` and the single-device predicts."""
    group = mesh.get_group(MODEL_AXIS)
    out = {}
    for name, x in model.state_dict().items():
        spec = vit_tp_spec(name, x)
        out[name] = gather_dim(x, spec.index(MODEL_AXIS), group) if MODEL_AXIS in spec else x
    return out
