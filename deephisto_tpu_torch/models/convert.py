"""Weight bridge: the JAX package's flax ResNet and ViT variables → state
dicts of the port's :class:`~.resnet.ResNet` and :class:`~.vit.ViT`, back
again (:func:`torch_to_flax`, for the flax-format checkpoints), and its int8
``qvariables`` → the quantized parameters of the port's
:class:`~.quantize.QuantizedResNet` (:func:`flax_qvariables_to_torch`) and
:class:`~.quantize_vit.QuantizedViT` (:func:`flax_vit_qvariables_to_torch`),
and ``fold_vit_stem``'s variables → the tensors of the port's
:class:`~.vit.FoldedStemViT` (:func:`flax_folded_stem_to_torch`).

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
* the ViT's ``pos_embed`` is copied as it is;
* BN's ``num_batches_tracked`` has no flax leaf (flax's BatchNorm keeps no
  count); it is 0 after a load and dropped on the way back.
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
    tree with numpy leaves (or the ``{"params": ...}`` tree of a parameter
    tree alone, such as an optimizer's moments). Returns float32 tensors,
    copies, keyed as the port's state dict, ready for ``load_state_dict``
    (which casts to each parameter's dtype)."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables_np["params"]):
        if path == ("pos_embed",):  # the ViT's one top-level parameter
            sd["pos_embed"] = torch.from_numpy(np.array(leaf, np.float32))
            continue
        module, name = ".".join(path[:-1]), path[-1]
        if name == "kernel":
            leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
            name = "weight"
        else:
            name = _PARAM[name]
        sd[f"{module}.{name}"] = torch.from_numpy(np.array(leaf, np.float32, order="C"))
    for path, leaf in _leaves(variables_np.get("batch_stats", {})):
        module = ".".join(path[:-1])
        sd[f"{module}.{_STAT[path[-1]]}"] = torch.from_numpy(
            np.array(leaf, np.float32, order="C")
        )
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_vit_to_torch(variables_np) -> dict[str, torch.Tensor]:
    """``variables_np``: the flax ViT's ``{"params": ...}`` tree (with
    ``"batch_stats"`` for the ``conv`` stem) with numpy leaves. Returns
    float32 tensors keyed as the port's ViT state dict. The names and rules
    are the ResNet's, plus ``pos_embed``."""
    return flax_resnet_to_torch(variables_np)


def _flax_key(name: str, ndim: int) -> tuple[str, tuple[str, ...]] | None:
    """The (collection, path) of the flax leaf of the port's state-dict entry
    ``name`` of ``ndim`` dimensions; None for ``num_batches_tracked``."""
    if name == "pos_embed":
        return "params", ("pos_embed",)
    *module, leaf = name.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", (*module, leaf[len("running_"):])
    if leaf == "weight":  # conv (4-d) and Dense (2-d) kernels; norm scales (1-d)
        return "params", (*module, "kernel" if ndim in (2, 4) else "scale")
    if leaf == "bias":
        return "params", (*module, "bias")
    raise ValueError(f"{name}: no flax leaf for this state-dict entry")


def torch_to_flax(named_tensors) -> dict:
    """The reverse of :func:`flax_resnet_to_torch` for the ResNet and ViT
    families: ``(name, tensor)`` pairs of a port state dict (or of any
    tensors laid out as its parameters, such as Adam's moments) → the flax
    ``{"params": ..., "batch_stats": ...}`` tree of float32 numpy leaves,
    conv kernels OIHW → HWIO and Dense kernels (out, in) → (in, out)."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for name, t in named_tensors:
        key = _flax_key(name, t.ndim)
        if key is None:
            continue
        t = t.detach().float()
        if t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        elif t.ndim == 2:
            t = t.t()
        node = tree[key[0]]
        for part in key[1][:-1]:
            node = node.setdefault(part, {})
        node[key[1][-1]] = t.contiguous().cpu().numpy()  # transposed where t lies
    return tree


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


def flax_vit_qvariables_to_torch(qvariables_np) -> dict:
    """``qvariables_np``: the ``{"params": ...}`` tree that the JAX
    package's ``quantize_vit`` returns, with numpy leaves. Returns the
    ``qparams`` dict that :class:`~.quantize_vit.QuantizedViT` takes, with
    the same names: conv ``kernel_q`` HWIO → (Cout, KH, KW, Cin) int8, Dense
    ``kernel_q`` (K, N) → (N, K) int8, every other leaf (``dequant``,
    ``bias``, ``in_inv_scale``, ``pos_embed``, the norms' ``scale`` and
    ``bias``, the head's (in, out) ``kernel``) as float32 tensors."""

    def convert(leaves: dict) -> dict:
        out = {}
        for k, v in leaves.items():
            if hasattr(v, "items"):
                out[k] = convert(v)
                continue
            v = np.asarray(v)
            if k == "kernel_q":
                if v.dtype != np.int8:
                    raise ValueError(f"kernel_q must be int8, got {v.dtype}")
                v = v.transpose(3, 0, 1, 2) if v.ndim == 4 else v.T
                out[k] = torch.from_numpy(np.ascontiguousarray(v))
            else:
                out[k] = torch.from_numpy(np.array(v, np.float32))
        return out

    return convert(qvariables_np["params"])


def flax_folded_stem_to_torch(folded_params_np) -> dict[str, torch.Tensor]:
    """The stem leaves of the ``{"params": ...}`` tree that the JAX
    package's ``fold_vit_stem`` returns (``stem0_kernel``,
    ``stem0_kernel_u8``, ``stem{i}_kernel``, ``stem{i}_bias``,
    ``embed_kernel``, ``embed_bias``) → the tensors
    :class:`~.vit.FoldedStemViT` holds: kernels HWIO → OIHW, float32. Its
    ``"inner"`` variables (the ViT's own) go through
    :func:`flax_vit_to_torch` into the model the folded one shares."""
    out = {}
    for k, v in folded_params_np["params"].items():
        if k == "inner":
            continue
        v = np.array(v, np.float32)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out
