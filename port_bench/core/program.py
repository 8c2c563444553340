"""The system under test: the port's ``ServingEngine`` over the
configuration's model with the benchmark's weights. The only module of
the harness that reaches into the program besides the kinds' calls to
the engine."""

from __future__ import annotations

import torch


def build_engine(cfg: dict, family, sd: dict, mode: str, device):
    """``ServingEngine`` serving ``mode`` with the configuration's model,
    precision and engine arguments; the model holds ``sd``."""
    from deephisto_tpu_torch.serve.engine import ServingEngine

    model = family.program_model(cfg).to(device)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    engine_cfg = {
        "model": {"n_classes": cfg["num_classes"], "arch": cfg["arch"], "depth": cfg["depth"],
                  "stem": cfg["stem"], "width": cfg.get("width", 1),
                  "patch": cfg.get("patch", 16)},
        "dataset": {"patch_size": cfg["patch_size"]},
    }
    return ServingEngine(model, engine_cfg, int8=cfg["int8"], mode=mode, device=device,
                         **cfg["engine"])


def free(device) -> None:
    """Return the caching allocator's blocks once the program's state is gone."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
