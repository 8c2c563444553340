"""The (data, model) device mesh and the batch sharding rules, a port of
``deephisto_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` over the devices one process
sees and lets GSPMD place the work. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the current
process group, one rank a process (``parallel/__init__.py``): ``data`` is
the batch axis, ``model`` the tensor-parallel one. A rank reads its
coordinates with ``mesh.get_local_rank(DATA_AXIS)`` and the group of an axis
with ``mesh.get_group(DATA_AXIS)``.

``batch_sharding`` becomes :class:`BatchSharding`: which rows of a global
batch's leading axis this rank holds and the group they are reduced over.
GSPMD placed a global array by a ``NamedSharding``; an SPMD rank instead
takes its rows of the global batch every rank was given
(:func:`shard_batch`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_device_type() -> str:
    """``"cuda"`` where this process has a card, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call deephisto_tpu_torch.parallel.initialize() (under "
            "torchrun) or torch.distributed.init_process_group first"
        )
    return dist.get_world_size()


def make_mesh(data: int | None = None, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the process group, ranks laid
    out row-major (rank = data_index · model + model_index)."""
    n = _world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The length of ``mesh``'s axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))


class BatchSharding(NamedTuple):
    """This rank's share of a leading batch axis: shard ``index`` of
    ``count`` equal shards, reduced over ``group``."""

    index: int
    count: int
    group: object

    def rows(self, n: int) -> slice:
        """The rows of an ``n``-row global batch this rank holds."""
        if n % self.count:
            raise ValueError(f"global batch {n} does not divide over {self.count} shards")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """Leading-axis sharding over the mesh's ``data`` axis."""
    return BatchSharding(mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS),
                         mesh.get_group(DATA_AXIS))


def take_rows(batch, sharding: BatchSharding):
    """``batch`` (a tensor, an array, or a tuple or list of them) cut to
    this rank's rows of its leading axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(take_rows(b, sharding) for b in batch)
    if not isinstance(batch, (torch.Tensor, np.ndarray)):
        raise TypeError(f"cannot shard a {type(batch).__name__}")
    return batch[sharding.rows(batch.shape[0])]


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a global batch over the ``data`` axis: every rank
    is handed the same global batch and keeps its shard of the leading
    axis (the leading axis must divide over the axis)."""
    return take_rows(batch, batch_sharding(mesh))


def replicated(module_or_state, mesh: DeviceMesh):
    """Make every rank of ``mesh`` hold rank 0's copy of a module's
    parameters and buffers, or of a train state's model and optimizer
    moments: one broadcast a tensor, in place. Returns its argument."""
    if mesh.size() != _world():
        raise ValueError(f"the mesh spans {mesh.size()} of {_world()} ranks")
    model = getattr(module_or_state, "model", module_or_state)
    tensors = [*model.parameters(), *model.buffers()]
    opt = getattr(module_or_state, "optimizer", None)
    if opt is not None:
        for p in model.parameters():
            tensors += [v for v in opt.state.get(p, {}).values()
                        if isinstance(v, torch.Tensor) and v.dim() > 0]
    for t in tensors:
        dist.broadcast(t.data, 0)
    return module_or_state
