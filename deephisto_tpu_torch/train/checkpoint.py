"""Checkpoints in the JAX package's format, a port of
``deephisto_tpu/train/checkpoint.py``: the best-model weights
(``best_model.msgpack``) and the full train state for resume, as flax
msgpack files that the JAX package's ``load_model`` / ``load_train_state``
read, and that the port reads when the JAX package wrote them.

* Weights: ``{"params", "batch_stats"}`` in flax's names and layouts
  (:func:`~..models.convert.torch_to_flax`), float32.
* Train state: the weights, then ``opt_state`` in the state-dict layout of
  optax's ``inject_hyperparams(adam|adamw)`` (``count``; ``hyperparams``
  ``b1``, ``b2``, ``eps``, ``eps_root``, ``learning_rate`` and, for AdamW,
  ``weight_decay``; ``hyperparams_states``; ``inner_state`` ``'0'``
  ``{count, mu, nu}``, ``'1'`` and for AdamW ``'2'`` empty), then ``step``,
  ``epoch`` and ``extra``. torch's Adam keeps a ``step``, ``exp_avg`` and
  ``exp_avg_sq`` per parameter; they map onto optax's one ``count`` (written
  outer and inner) and its ``mu`` and ``nu`` trees, with the parameters'
  transposes.

A :class:`~..models.patch_cls_simple.context.ContextWindowModel` is saved
as the model it wraps (``.inner``): the file is a plain base-model
checkpoint, as the JAX trainer writes it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..models.convert import flax_resnet_to_torch, torch_to_flax
from . import _msgpack
from .state import TrainState

BEST_MODEL_FILE = "best_model.msgpack"


def _base(model: nn.Module) -> nn.Module:
    return getattr(model, "inner", model)


def model_variables(model: nn.Module) -> dict:
    """The flax ``{"params", "batch_stats"}`` tree of ``model``'s weights."""
    return torch_to_flax(_base(model).state_dict().items())


def load_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Load a flax ``{"params", "batch_stats"}`` tree into ``model`` (the
    wrapped model of a ContextWindowModel) in place; returns ``model``."""
    _base(model).load_state_dict(flax_resnet_to_torch(variables))
    return model


def save_model(path: Path | str, model: nn.Module) -> Path:
    """Weights-only save (the best-model artifact)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _msgpack.dump(model_variables(model), path)
    return path


def load_model(path: Path | str) -> dict:
    """Load a weights-only checkpoint → ``{'params': ..., 'batch_stats': ...}``
    with numpy leaves (load it into a model with :func:`load_variables`)."""
    return _msgpack.unpackb(Path(path).read_bytes())


def _f32(x: float) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _adam_kind(opt: torch.optim.Optimizer) -> bool:
    """True for AdamW, False for Adam; raises for any other optimizer or
    setting that optax's adam/adamw state cannot hold."""
    if not isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError(f"only Adam and AdamW states are saved, not {type(opt).__name__}")
    if len(opt.param_groups) != 1 or opt.param_groups[0].get("amsgrad"):
        raise ValueError("the optimizer must have one parameter group and no amsgrad")
    return isinstance(opt, torch.optim.AdamW)


def _opt_state(model: nn.Module, opt: torch.optim.Optimizer, step: int) -> dict:
    adamw = _adam_kind(opt)
    group = opt.param_groups[0]
    named = list(model.named_parameters())

    def moment(key):
        return torch_to_flax(
            (n, opt.state.get(p, {}).get(key, torch.zeros_like(p))) for n, p in named
        )["params"]

    count = np.asarray(step, dtype=np.int32)
    hyper = {"b1": _f32(group["betas"][0]), "b2": _f32(group["betas"][1]),
             "eps": _f32(group["eps"]), "eps_root": _f32(0.0),
             "learning_rate": _f32(group["lr"])}
    inner = {"0": {"count": count, "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")},
             "1": {}}
    if adamw:
        hyper["weight_decay"] = _f32(group["weight_decay"])
        inner["2"] = {}
    return {"count": count, "hyperparams": hyper, "hyperparams_states": {},
            "inner_state": inner}


def save_train_state(path: Path | str, state: TrainState, epoch: int,
                     extra: dict | None = None) -> Path:
    """Full-state checkpoint for resume (weights + optimizer + counters)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    model = _base(state.model)
    payload = model_variables(model)
    payload.update(
        opt_state=_opt_state(model, state.optimizer, state.step),
        step=int(state.step),
        epoch=int(epoch),
        extra=extra or {},
    )
    _msgpack.dump(payload, path)
    return path


def load_train_state(path: Path | str, state: TrainState):
    """Restore a full-state checkpoint into ``state`` (its model and
    optimizer, in place): weights, BatchNorm statistics, each parameter's
    Adam moments and step, the optimizer's learning rate and the step count.
    The betas, eps and weight decay stay as the optimizer was built (from
    the same config). Returns ``(state, epoch, extra)``."""
    raw = _msgpack.unpackb(Path(path).read_bytes())
    model = _base(state.model)
    opt = state.optimizer
    adamw = _adam_kind(opt)
    opt_raw = raw["opt_state"]
    if ("weight_decay" in opt_raw["hyperparams"]) != adamw:
        raise ValueError(f"{path}: the checkpoint's optimizer is not the state's "
                         f"({type(opt).__name__})")
    load_variables(model, raw)
    adam = opt_raw["inner_state"]["0"]
    mu = flax_resnet_to_torch({"params": adam["mu"]})
    nu = flax_resnet_to_torch({"params": adam["nu"]})
    count = float(adam["count"])
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.empty_like(p).copy_(mu[name]),
            "exp_avg_sq": torch.empty_like(p).copy_(nu[name]),
        }
    opt.param_groups[0]["lr"] = float(opt_raw["hyperparams"]["learning_rate"])
    state.step = int(raw["step"])
    return state, int(raw["epoch"]), dict(raw.get("extra", {}))
