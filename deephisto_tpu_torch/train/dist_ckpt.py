"""Sharded, async, mesh-portable, rotating train-state checkpoints on
``torch.distributed.checkpoint`` (DCP): the port's counterpart of
``deephisto_tpu/train/orbax_ckpt.py``.

The msgpack path (:mod:`.checkpoint`) gathers the whole train state to the
host and writes one file: right for single-device training, wrong for a
state sharded over a mesh, whose shards would first be gathered to one rank,
and the write blocks the train loop. This module is the scale path:

- **sharded**: each rank writes only what it owns. A data-parallel replica
  is written once, by one rank (DCP's planner drops the duplicates). The
  tensor-parallel shards of ``parallel/tensor.py`` and their Adam moments
  are written as ``DTensor``\\ s sharded as ``vit_tp_spec`` says, and each
  pipeline stage writes its blocks under their global names
  ``block{first_block + j}``, so no two ranks write the same piece.
- **async**: with an async manager ``save_train_state`` returns once the
  state is copied off the card; the write overlaps the next train steps,
  and ``wait_until_finished`` joins it. Across ranks the writes' own
  collectives run on a gloo group of the manager's, never the training's.
- **mesh-shape portable**: ``restore_train_state`` reads into the
  *template* state's own layout, so a tensor-parallel or pipeline save
  restores into a single-device state, a single-device save into a sharded
  one, and a data-parallel save of any world at another.
- **rotating**: ``max_to_keep`` bounds the disk. A step counts once DCP has
  written its ``.metadata`` (the last file of a save, written after every
  rank's data); the oldest step is deleted only after a newer write has
  completed.

Layout: ``<directory>/<step>/`` holds DCP's files and ``meta.json`` with
``epoch`` and ``extra`` (the msgpack payload's fields). The state's keys are
the canonical (single-device) model's: ``model.<name>`` for each parameter
and buffer, ``optim.{exp_avg,exp_avg_sq,step}.<name>`` for Adam/AdamW,
``optim.lr`` and the step count ``step`` (an int). These directories are the
port's own: the JAX package's orbax directories are not read here, nor these
there; the flax msgpack file is the format both packages read.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch import nn

from ..models.convert import torch_to_flax
from .checkpoint import _adam_kind, _base
from .state import TrainState

__all__ = [
    "CheckpointManager",
    "checkpoint_manager",
    "save_train_state",
    "restore_train_state",
    "load_model",
    "latest_step",
]

META_FILE = "meta.json"


def _multi_rank() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if _multi_rank() else 0


class CheckpointManager:
    """Step directories under ``directory``: saves (async when
    ``async_save``), rotation to ``max_to_keep`` completed steps, and a save
    every ``save_interval_steps``. Every rank of a group makes one and calls
    it alike; rank 0 writes the sidecar and deletes old steps."""

    def __init__(self, directory: Path | str, max_to_keep: int = 3, async_save: bool = True,
                 save_interval_steps: int = 1):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.save_interval_steps = max(1, int(save_interval_steps))
        self._pending: list[tuple[int, object]] = []  # (step, future) of writes in flight
        self._group = None
        self._meshes: dict = {}  # (process group, device type) -> DeviceMesh of TP shards

    # -- the group the writes use ----------------------------------------
    def group(self):
        """A gloo group of the manager's own across ranks (made at first use,
        by every rank at once), None in a single process."""
        if not _multi_rank():
            return None
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def _dcp_kw(self) -> dict:
        group = self.group()
        return {"no_dist": True} if group is None else {"process_group": group}

    # -- steps -----------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def all_steps(self) -> list[int]:
        """The completed steps (DCP's ``.metadata`` written), oldest first."""
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / ".metadata").is_file())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        last = max([s for s, _ in self._pending] + self.all_steps(), default=None)
        return (last is None or step > last) and step % self.save_interval_steps == 0

    def save(self, step: int, state_dict: dict, meta: dict) -> bool:
        """Write ``state_dict`` as step ``step`` with the JSON sidecar
        ``meta``; False (and nothing written) when the step is not due."""
        self._reap()
        if not self.should_save(step):
            return False
        path = self.step_dir(step)
        path.mkdir(parents=True, exist_ok=True)
        if _rank() == 0:
            tmp = path / f"{META_FILE}.tmp"
            tmp.write_text(json.dumps(meta))
            os.replace(tmp, path / META_FILE)
        if self.async_save:
            self._pending.append((step, dcp.async_save(state_dict, checkpoint_id=str(path),
                                                       **self._dcp_kw())))
        else:
            dcp.save(state_dict, checkpoint_id=str(path), **self._dcp_kw())
            self._rotate()
        return True

    def _reap(self, wait: bool = False) -> None:
        """Join the finished writes (all of them when ``wait``), raising a
        write's error, then rotate."""
        still = []
        for step, fut in self._pending:
            if wait or fut.done():
                fut.result()
            else:
                still.append((step, fut))
        self._pending = still
        self._rotate()

    def _rotate(self) -> None:
        if _rank() != 0 or self.max_to_keep is None:
            return
        done = self.all_steps()
        for step in done[: max(0, len(done) - self.max_to_keep)]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until every write in flight has completed."""
        self._reap(wait=True)

    def close(self) -> None:
        self.wait_until_finished()

    def read_meta(self, step: int) -> dict:
        return json.loads((self.step_dir(step) / META_FILE).read_text())


def checkpoint_manager(
    directory: Path | str,
    *,
    max_to_keep: int = 3,
    async_save: bool = True,
    save_interval_steps: int = 1,
) -> CheckpointManager:
    """A rotating (async by default) manager rooted at ``directory``.

    Call ``.wait_until_finished()`` before reading a just-saved step and
    ``.close()`` when done (both no-ops for sync managers)."""
    return CheckpointManager(directory, max_to_keep=max_to_keep, async_save=async_save,
                             save_interval_steps=save_interval_steps)


def latest_step(mgr: CheckpointManager) -> int | None:
    return mgr.latest_step()


# -- the train state as DCP's flat state dict ------------------------------

def _canonical(model: nn.Module):
    """``local name -> canonical name`` of ``model``'s entries: a pipeline
    stage's ``vit.<n>`` is ``<n>`` and its ``blocks.<j>.<n>`` is
    ``block<first_block + j>.<n>``; every other model's names are its own."""
    from ..parallel.pipeline import PipelineStage

    if not isinstance(model, PipelineStage):
        return lambda name: name

    def name_of(name: str) -> str:
        head, _, rest = name.partition(".")
        if head == "vit":
            return rest
        j, _, leaf = rest.partition(".")
        return f"block{model.first_block + int(j)}.{leaf}"

    return name_of


def _sharders(model: nn.Module, meshes: dict):
    """``local name -> (tensor -> tensor)``: wraps a tensor-parallel shard
    (and its Adam moments) as a ``DTensor`` sharded as ``vit_tp_spec`` says,
    over a one-dimensional mesh of its module's group; other tensors pass."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from ..parallel.mesh import MODEL_AXIS
    from ..parallel.tensor import ColumnParallelDense, RowParallelDense, vit_tp_spec

    groups = {prefix: m.group for prefix, m in model.named_modules()
              if isinstance(m, (ColumnParallelDense, RowParallelDense))}

    def wrap(name: str, t: torch.Tensor) -> torch.Tensor:
        group = groups.get(name.rpartition(".")[0])
        spec = vit_tp_spec(name, t)
        if group is None or MODEL_AXIS not in spec:
            return t
        key = (group, t.device.type)
        if key not in meshes:
            meshes[key] = DeviceMesh.from_group(group, t.device.type)
        return DTensor.from_local(t, meshes[key], [Shard(spec.index(MODEL_AXIS))],
                                  run_check=False)

    return wrap


def _ensure_moments(opt: torch.optim.Optimizer, params) -> None:
    """Adam's state for every parameter that has none yet (a state before
    its first step), as that step would create it."""
    for p in params:
        st = opt.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _flat_state(state: TrainState, meshes: dict) -> dict:
    """The DCP state dict of ``state`` (module docstring), whose tensors
    share storage with the model and the optimizer's state."""
    model = _base(state.model)
    opt = state.optimizer
    _adam_kind(opt)
    name_of, wrap = _canonical(model), _sharders(model, meshes)
    params = list(model.named_parameters())
    _ensure_moments(opt, [p for _, p in params])
    out = {f"model.{name_of(n)}": wrap(n, t) for n, t in model.state_dict().items()}
    for n, p in params:
        st = opt.state[p]
        out[f"optim.exp_avg.{name_of(n)}"] = wrap(n, st["exp_avg"])
        out[f"optim.exp_avg_sq.{name_of(n)}"] = wrap(n, st["exp_avg_sq"])
        out[f"optim.step.{name_of(n)}"] = st["step"]
    out["optim.lr"] = float(opt.param_groups[0]["lr"])
    out["step"] = int(state.step)
    return out


def save_train_state(
    mgr: CheckpointManager,
    step: int,
    state: TrainState,
    epoch: int,
    extra: dict | None = None,
) -> bool:
    """Persist ``state`` (sharded, async if the manager is) as step
    ``step``. Returns whether a save happened (the manager skips a step that
    is not due). ``epoch`` and ``extra`` go into the JSON sidecar."""
    meta = {"epoch": int(epoch), "extra": extra or {}}
    return mgr.save(int(step), _flat_state(state, mgr._meshes), meta)


def restore_train_state(mgr: CheckpointManager, state: TrainState, step: int | None = None):
    """Restore step ``step`` (the latest completed one by default) into
    ``state``, in place: its model's parameters and buffers, Adam's
    moments and step, the learning rate and the step count.

    ``state`` is the template: build it as at train start (the same model
    and optimizer), laid out however the current run shards it; every rank
    reads only its own pieces. Returns ``(state, epoch, extra)``, the
    msgpack loader's contract."""
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {mgr.directory}")
    flat = _flat_state(state, mgr._meshes)
    # DCP loads each tensor in place: the state dict's tensors (and the
    # DTensors' local shards) share storage with the model and optimizer
    dcp.load(flat, checkpoint_id=str(mgr.step_dir(step)), **mgr._dcp_kw())
    opt = state.optimizer
    opt.param_groups[0]["lr"] = float(flat["optim.lr"])
    state.step = int(flat["step"])
    meta = mgr.read_meta(step)
    return state, int(meta["epoch"]), dict(meta.get("extra", {}))


def load_model(directory: Path | str, step: int | None = None) -> dict:
    """Weights-only load of a train-state checkpoint directory (the latest
    completed step by default) → ``{"params": ..., "batch_stats": ...}`` as
    float32 numpy in flax's layout, the form ``train/checkpoint.py:load_model``
    returns: the serving-side reader, which needs no template. Each rank
    reads the whole model."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    mgr = CheckpointManager(directory, async_save=False)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {directory}")
    reader = FileSystemReader(str(mgr.step_dir(step)))
    md = reader.read_metadata()
    weights = {k: torch.empty(v.size, dtype=v.properties.dtype)
               for k, v in md.state_dict_metadata.items()
               if k.startswith("model.") and isinstance(v, TensorStorageMetadata)}
    dcp.load(weights, storage_reader=reader, no_dist=True)
    return torch_to_flax((k[len("model."):], t) for k, t in weights.items())
