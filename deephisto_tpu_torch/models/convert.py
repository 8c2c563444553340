"""Weight bridge: the JAX package's flax ResNet and ViT variables → state
dicts of the port's :class:`~.resnet.ResNet` and :class:`~.vit.ViT`, and its
int8 ``qvariables`` → the quantized parameters of the port's
:class:`~.quantize.QuantizedResNet` (:func:`flax_qvariables_to_torch`).

Each pair of models shares module names (ResNet: ``conv1``, ``bn1``,
``layer{i}_{j}/conv{k}``, ``bn{k}``, ``downsample_conv``, ``downsample_bn``,
``fc``, deephisto_tpu/models/resnet.py:24-166; ViT: ``embed``,
``stem_conv{i}``, ``stem_bn{i}``, ``stem_gn{i}``, ``block{i}/attn/qkv``, ...,
deephisto_tpu/models/vit.py:92-250), so the mapping is by name:

* conv ``kernel`` (HWIO) → ``weight`` (OIHW); Dense ``kernel`` (in, out) →
  Linear ``weight`` (out, in); ``bias`` → ``bias``;
* BN, LayerNorm and GroupNorm ``scale``/``bias`` (params) →
  ``weight``/``bias``; BN ``mean``/``var`` (batch_stats) →
  ``running_mean``/``running_var``;
* the ViT's ``pos_embed`` is copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM = {"scale": "weight", "bias": "bias"}
_STAT = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_resnet_to_torch(variables_np) -> dict[str, torch.Tensor]:
    """``variables_np``: the flax ``{"params": ..., "batch_stats": ...}``
    tree with numpy leaves. Returns float32 tensors keyed as the port's
    state dict, ready for ``load_state_dict`` (which casts to each
    parameter's dtype)."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables_np["params"]):
        if path == ("pos_embed",):  # the ViT's one top-level parameter
            sd["pos_embed"] = torch.from_numpy(np.ascontiguousarray(leaf, np.float32))
            continue
        module, name = ".".join(path[:-1]), path[-1]
        if name == "kernel":
            leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
            name = "weight"
        else:
            name = _PARAM[name]
        sd[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(leaf, np.float32))
    for path, leaf in _leaves(variables_np.get("batch_stats", {})):
        module = ".".join(path[:-1])
        sd[f"{module}.{_STAT[path[-1]]}"] = torch.from_numpy(
            np.ascontiguousarray(leaf, np.float32)
        )
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_vit_to_torch(variables_np) -> dict[str, torch.Tensor]:
    """``variables_np``: the flax ViT's ``{"params": ...}`` tree (with
    ``"batch_stats"`` for the ``conv`` stem) with numpy leaves. Returns
    float32 tensors keyed as the port's ViT state dict. The names and rules
    are the ResNet's, plus ``pos_embed``."""
    return flax_resnet_to_torch(variables_np)


def flax_qvariables_to_torch(qvariables_np) -> dict:
    """``qvariables_np``: the ``{"params": ...}`` tree that the JAX
    package's ``quantize_resnet`` returns, with numpy leaves. Returns the
    ``qparams`` dict that :class:`~.quantize.QuantizedResNet` takes: per
    conv ``kernel_q`` HWIO → (Cout, KH, KW, Cin) int8, ``dequant``,
    ``bias`` and ``in_inv_scale`` f32 as they are, and ``fc``'s (in, out)
    kernel and bias."""
    out = {}
    for name, leaves in qvariables_np["params"].items():
        leaves = {k: np.asarray(v) for k, v in leaves.items()}
        if name == "fc":
            out["fc"] = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in leaves.items()}
            continue
        kq = leaves["kernel_q"]
        if kq.dtype != np.int8:
            raise ValueError(f"{name}: kernel_q must be int8, got {kq.dtype}")
        out[name] = {
            "kernel_q": torch.from_numpy(np.ascontiguousarray(kq.transpose(3, 0, 1, 2))),
            "dequant": torch.from_numpy(np.array(leaves["dequant"], np.float32)),
            "bias": torch.from_numpy(np.array(leaves["bias"], np.float32)),
            "in_inv_scale": torch.tensor(float(leaves["in_inv_scale"]), dtype=torch.float32),
        }
    return out
