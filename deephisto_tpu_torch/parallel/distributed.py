"""Multi-process wiring and node-aware work sharding, a port of
``deephisto_tpu/parallel/distributed.py``.

The JAX package wires ``jax.distributed`` (a coordinator and a global device
view) and builds a ``(host, data, model)`` mesh whose ``host`` axis spans
processes. Here every rank is a process already (``parallel/__init__.py``):

* :func:`initialize` joins the process group ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
  and binds the rank's card, ``cuda:LOCAL_RANK % device_count()``;
* :func:`make_global_mesh` lays the ranks out as ``(host, data, model)``,
  ``host`` the number of nodes (``torchrun`` numbers the ranks node by
  node, so a node's ranks are contiguous along ``data`` × ``model``);
* :func:`shard_slides` gives each rank its own slides, so no slide-sized
  tensor crosses nodes; only the gradient all-reduce and a band-sharded
  predict's one map reduce do (:func:`global_band_mesh`).

One process runs the same program text: :func:`initialize` returns False
and joins nothing, and a caller that wants a mesh of one rank makes a
process group of one itself.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import DATA_AXIS, MODEL_AXIS, BatchSharding, _world, axis_size, mesh_device_type, replicated

HOST_AXIS = "host"
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> bool:
    """Join the process group (idempotent). The arguments default to
    torchrun's environment; ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``). ``backend``: ``"nccl"`` where the process has a card,
    ``"gloo"`` otherwise; NCCL takes one card a rank, so ranks that share a
    card must ask for ``"gloo"`` (it is never chosen for them). Binds
    ``cuda:LOCAL_RANK % device_count()`` as the current device first.
    Returns True when the group is (now) live, False for a world of one
    with no ``init_method`` (nothing to join)."""
    if dist.is_initialized():
        return True
    env_n = os.environ.get("WORLD_SIZE")
    n = world_size if world_size is not None else int(env_n or 1)
    if init_method is None and n == 1:
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    kwargs = {}
    if cuda:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
            if per_node > torch.cuda.device_count():
                raise ValueError(
                    f"NCCL takes one card a rank: {per_node} ranks on this node share "
                    f"{torch.cuda.device_count()} card(s); pass backend='gloo'"
                )
            kwargs["device_id"] = device
    elif backend == "nccl":
        raise ValueError("NCCL needs a CUDA card; this process has none")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=n,
                            rank=rank, timeout=TIMEOUT, **kwargs)
    return True


def host_count() -> int:
    """Nodes in the process group: the world over torchrun's
    ``LOCAL_WORLD_SIZE`` (1 without it)."""
    n = _world()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % per_node:
        raise ValueError(f"{n} ranks do not divide into nodes of {per_node}")
    return n // per_node


def make_global_mesh(model: int = 1, data: int | None = None) -> DeviceMesh:
    """A ``(host, data, model)`` mesh over every rank: ``host`` the number of
    nodes, ``data`` × ``model`` the ranks of a node."""
    hosts = host_count()
    per_host = _world() // hosts
    if data is None:
        data = per_host // model
    if data * model != per_host:
        raise ValueError(f"per-host mesh {data}x{model} != {per_host} local ranks")
    return DeviceMesh(mesh_device_type(), torch.arange(_world()).reshape(hosts, data, model),
                      mesh_dim_names=(HOST_AXIS, DATA_AXIS, MODEL_AXIS))


def _host_data(mesh: DeviceMesh) -> tuple[int, int, object]:
    """(index, count, group) of this rank along the flattened (host, data)
    axes; along ``data`` on a mesh with no ``host`` axis."""
    if HOST_AXIS not in mesh.mesh_dim_names:
        return (mesh.get_local_rank(DATA_AXIS), axis_size(mesh, DATA_AXIS),
                mesh.get_group(DATA_AXIS))
    hosts, data = axis_size(mesh, HOST_AXIS), axis_size(mesh, DATA_AXIS)
    index = mesh.get_local_rank(HOST_AXIS) * data + mesh.get_local_rank(DATA_AXIS)
    group = mesh[HOST_AXIS, DATA_AXIS]._flatten().get_group()
    return index, hosts * data, group


def global_batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """The batch's leading axis over the combined (host, data) axes: the
    global data-parallel layout."""
    return BatchSharding(*_host_data(mesh))


def replicated_global(module_or_state, mesh: DeviceMesh):
    """:func:`~.mesh.replicated` over every rank of a global mesh."""
    return replicated(module_or_state, mesh)


def shard_slides(img_anno_paths: list, process_id: int | None = None,
                 process_count: int | None = None) -> list:
    """This rank's slide subset, round-robin by rank (pure: pass
    ``process_id``/``process_count`` to take another rank's)."""
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    return list(img_anno_paths)[process_id::process_count]


def global_band_mesh(mesh: DeviceMesh) -> tuple[int, object]:
    """Band count and the group that sums the band maps for a row-banded
    predict: the bands split over the host × data product of a global mesh
    (over ``data`` on a mesh with no ``host`` axis), the map reduced over
    its group."""
    _, count, group = _host_data(mesh)
    return count, group


def band_layout(mesh: DeviceMesh) -> tuple[int, int, object]:
    """(this rank's band, band count, reducing group): :func:`global_band_mesh`
    and the rank's place in that group."""
    count, group = global_band_mesh(mesh)
    return dist.get_rank(group), count, group
