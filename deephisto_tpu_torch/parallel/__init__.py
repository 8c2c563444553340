"""Parallelism: the device mesh, the sharding rules and the multi-process
wiring, a port of ``deephisto_tpu/parallel``.

The model of execution is not the JAX package's. There one process (a
single controller) sees every device, and GSPMD or ``shard_map`` places the
work on a ``jax.sharding.Mesh``. The port is SPMD: one process a rank,
started by ``torchrun`` (or by ``torch.multiprocessing`` in the tests and in
``chip_smoke.py``), joined into a ``torch.distributed`` process group
(:func:`initialize`), with a ``torch.distributed.device_mesh.DeviceMesh``
over its ranks (:func:`make_mesh`, :func:`make_global_mesh`,
:func:`make_pp_mesh`). So:

* every entry point that takes ``mesh=`` is called by every rank of the
  mesh with the same arguments (the whole global batch, the whole slide),
  each rank takes its share, and each returns the same result on every
  rank;
* files (checkpoints, the metrics CSV, plots, maps, PNGs) are written by
  rank 0 only;
* the collectives are written out (``_comm.py``): NCCL carries them where
  each rank has its own card, gloo on the CPU and among ranks that share
  one card (NCCL refuses two ranks on a device).

What each path does:

* data parallelism (``predict_full_fused(mesh=)``, ``make_steps(model,
  mesh)``, ``make_fused_epoch(..., mesh=)``, ``train(cfg, mesh=)``): each
  rank takes its rows of every batch; the predict's maps and the training
  gradients are all-reduced; BatchNorm takes the global batch's
  statistics in train mode;
* row bands of the slide (:func:`predict_full_spatial`,
  :func:`predict_full_fcn_spatial`), one all-reduce of the map, and for the
  fcn mode one halo exchange of logit rows between neighbouring bands;
* tensor parallelism of the ViT's MLPs (:func:`place_vit_tensor_parallel`);
* a GPipe pipeline of the ViT's blocks (:func:`make_pipeline_steps`).
"""

from .distributed import (
    HOST_AXIS,
    global_band_mesh,
    global_batch_sharding,
    initialize,
    make_global_mesh,
    replicated_global,
    shard_slides,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    BatchSharding,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from .pipeline import (
    STAGE_AXIS,
    create_pipeline_state,
    make_pipeline_steps,
    make_pp_mesh,
    merge_vit_params,
    pipeline_params_to_canonical,
    split_vit_params,
)
from .spatial import band_partition, predict_full_fcn_spatial, predict_full_spatial
from .tensor import place_vit_tensor_parallel, vit_tp_shardings, vit_tp_state_dict

__all__ = [
    "place_vit_tensor_parallel",
    "vit_tp_shardings",
    "vit_tp_state_dict",
    "STAGE_AXIS",
    "create_pipeline_state",
    "make_pipeline_steps",
    "make_pp_mesh",
    "merge_vit_params",
    "pipeline_params_to_canonical",
    "split_vit_params",
    "band_partition",
    "predict_full_fcn_spatial",
    "predict_full_spatial",
    "DATA_AXIS",
    "HOST_AXIS",
    "MODEL_AXIS",
    "BatchSharding",
    "batch_sharding",
    "global_band_mesh",
    "global_batch_sharding",
    "initialize",
    "make_global_mesh",
    "make_mesh",
    "replicated",
    "replicated_global",
    "shard_batch",
    "shard_slides",
]
