"""Pipeline-parallel ViT training, a GPipe schedule over a ``stage`` mesh
axis: a port of ``deephisto_tpu/parallel/pipeline.py``.

The transformer blocks are split into contiguous stages, one a rank of the
``stage`` axis of a ``(data, stage)`` mesh; the rest of the model (stem,
embed, ``pos_embed``, the final LayerNorm, the head) is replicated. The JAX
package runs the schedule as a ``lax.scan`` under ``shard_map`` with one
``ppermute`` a tick and differentiates through it. Here each rank runs the
same ticks in a Python loop, and the hop between stages is
``_comm.shift``, an autograd Function whose backward is the hop the other
way, so ``backward()`` runs the mirrored pipeline with no written schedule.

Semantics are GPipe's, synchronous with a full flush a step: with S stages
and M microbatches the loop runs M + S - 1 ticks (a bubble of
(S-1)/(M+S-1)). Every stage computes the embedding (stage 0's enters the
pipeline), and every stage computes the head, its loss masked out on every
stage but the last, so each parameter's gradient counts once; the
replicated parameters' gradients are then summed over the stage group
(the transpose of the replication) and every gradient averaged over the
``data`` group. The trajectory is single-device training's up to rounding.

Every rank calls every hop's backward, in the same order: the loss and the
result of every hop are the roots of one ``torch.autograd.backward`` (the
hops' results with a zero gradient), so a rank that does not consume a hop
(stage 0 takes its input from the embedding) still takes part in it.

Scope: the ViT family with the linear or the GroupNorm conv stem. The
BatchNorm conv stem is refused: its batch statistics are not the single
device's under the microbatch split.
"""

from __future__ import annotations

import copy

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..train.metrics import cross_entropy_loss
from ..train.state import TrainState, create_train_state
from ._comm import all_reduce_, average_gradients, gather_rows, shift
from .mesh import DATA_AXIS, _world, axis_size, batch_sharding, mesh_device_type

STAGE_AXIS = "stage"


def make_pp_mesh(stages: int = 4) -> DeviceMesh:
    """A ``(data, stage)`` mesh over every rank: a rank's stage is its rank
    modulo ``stages``."""
    n = _world()
    if n % stages:
        raise ValueError(f"{n} ranks do not divide into {stages} pipeline stages")
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(n // stages, stages),
                      mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


def _n_blocks(params: dict) -> int:
    n = len({k.split(".")[0] for k in params if k.startswith("block")})
    if n == 0:
        raise ValueError(
            "params have no block<i> entries — pipeline parallelism supports "
            "the ViT family (models/vit.py) only"
        )
    return n


def split_vit_params(params: dict, n_stages: int) -> tuple[dict, dict]:
    """Split a canonical ViT state dict into ``(shared, stacked)``: shared
    holds the embedding, ``pos_embed``, the final LayerNorm and the head;
    stacked every block's tensor by its name within the block, stacked to
    ``[n_stages, blocks_per_stage, ...]``. Stage s runs blocks s·K … s·K+K-1."""
    n_blocks = _n_blocks(params)
    if n_blocks % n_stages:
        raise ValueError(f"depth {n_blocks} does not divide into {n_stages} pipeline stages")
    k = n_blocks // n_stages
    names = [key[len("block0."):] for key in params if key.startswith("block0.")]
    stacked = {
        name: torch.stack([params[f"block{i}.{name}"] for i in range(n_blocks)])
        .reshape(n_stages, k, *params[f"block0.{name}"].shape)
        for name in names
    }
    shared = {key: v for key, v in params.items() if not key.startswith("block")}
    return shared, stacked


def merge_vit_params(shared: dict, stacked: dict) -> dict:
    """Inverse of :func:`split_vit_params`."""
    first = next(iter(stacked.values()))
    s, k = first.shape[0], first.shape[1]
    params = dict(shared)
    for name, a in stacked.items():
        flat = a.reshape(s * k, *a.shape[2:])
        for i in range(s * k):
            params[f"block{i}.{name}"] = flat[i]
    return params


class PipelineStage(nn.Module):
    """One rank's part of a pipelined ViT: ``vit`` the ViT with no blocks
    (its stem, embed, ``pos_embed``, LayerNorm and head, replicated) and
    ``blocks`` this stage's K blocks, the model's blocks ``first_block`` …
    ``first_block`` + K - 1."""

    def __init__(self, model: nn.Module, stage: int, n_stages: int):
        super().__init__()
        n_blocks = model.depth
        if n_blocks % n_stages:
            raise ValueError(f"depth {n_blocks} does not divide into {n_stages} pipeline stages")
        k = n_blocks // n_stages
        self.first_block = stage * k
        names = [f"block{i}" for i in range(n_blocks)]
        self.vit = copy.deepcopy(model, {id(getattr(model, n)): None for n in names})
        for n in names:
            delattr(self.vit, n)
        self.blocks = nn.ModuleList(copy.deepcopy(getattr(model, n))
                                    for n in names[stage * k : (stage + 1) * k])

    def shared_parameters(self):
        return self.vit.parameters()

    def run_stage(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


def _check_model(model) -> None:
    if getattr(model, "stem", "linear") not in ("linear", "conv_gn"):
        # the BatchNorm conv stem's batch statistics are not single-device
        # training's under the microbatch split: use stem='conv_gn'
        # (GroupNorm, sample-local) or tensor parallelism for stem='conv'
        raise ValueError(
            "pipeline parallelism supports stem='linear' and stem='conv_gn' "
            "ViTs; the BatchNorm conv stem composes with tensor parallelism "
            "instead"
        )


def create_pipeline_state(model, mesh: DeviceMesh, learning_rate: float,
                          weight_decay: float = 0.0) -> TrainState:
    """This rank's pipeline train state from a canonical ViT (every rank
    passes the same): its :class:`PipelineStage` (copies of the shared
    modules and of its stage's blocks) and an optimizer over them, Adam or
    AdamW as ``create_train_state`` makes them. The caller's model is left
    as it was."""
    _check_model(model)
    stage = PipelineStage(model, mesh.get_local_rank(STAGE_AXIS), axis_size(mesh, STAGE_AXIS))
    return create_train_state(stage, learning_rate, weight_decay=weight_decay)


def make_pipeline_steps(model, mesh: DeviceMesh, n_microbatches: int = 8):
    """GPipe train and eval steps over a ``(data, stage)`` mesh, with the
    call signatures of ``models/patch_cls_simple/train.make_steps``:
    ``train_step(state, images, labels) -> (state, loss, correct)`` and
    ``eval_step(state, images, labels) -> (loss, correct, logits)``, on the
    global batch every rank is given; each rank takes its ``data`` rows,
    whose count must divide into ``n_microbatches``. The state is
    :func:`create_pipeline_state`'s. Loss, correct count and logits are the
    global batch's, on every rank."""
    names = mesh.mesh_dim_names or ()
    if STAGE_AXIS not in names or DATA_AXIS not in names:
        raise ValueError(f"mesh must have ({DATA_AXIS}, {STAGE_AXIS}) axes")
    _check_model(model)
    n_stages = axis_size(mesh, STAGE_AXIS)
    stage = mesh.get_local_rank(STAGE_AXIS)
    last = stage == n_stages - 1
    stage_group, data = mesh.get_group(STAGE_AXIS), batch_sharding(mesh)
    m = n_microbatches

    def pp_logits(net: PipelineStage, images):
        """The schedule: logits real only on the last stage, and the hops'
        results (the backward's other roots)."""
        tokens = net.vit.embed_tokens(images)  # every stage: stage 0's enters
        b, n, d = tokens.shape
        if b % m:
            raise ValueError(f"per-device batch {b} not divisible by n_microbatches={m}")
        stream = tokens.reshape(m, b // m, n, d)
        buf = torch.zeros_like(stream[0])
        ys, hops = [], []
        for t in range(m + n_stages - 1):
            y = net.run_stage(stream[min(t, m - 1)] if stage == 0 else buf)
            buf = shift(y, stage_group)
            ys.append(y)
            hops.append(buf)
        # the last stage's microbatches 0..M-1 leave it at ticks S-1 … S+M-2
        outs = torch.cat(ys[n_stages - 1 : n_stages - 1 + m])
        return net.vit.classify(outs), hops

    def reduce_metrics(loss, correct):
        """Sum the masked loss and count over the stages, average the loss
        and sum the count over the data shards."""
        v = torch.stack([loss.detach(), correct.float()])
        if not last:
            v.zero_()
        all_reduce_(all_reduce_(v, stage_group), data.group)
        return v[0] / data.count, v[1].round().long()

    def train_step(state, images, labels):
        x, y = images[data.rows(images.shape[0])], labels[data.rows(labels.shape[0])]
        net = state.model
        net.train()
        logits, hops = pp_logits(net, x)
        ce = cross_entropy_loss(logits, y)
        state.optimizer.zero_grad(set_to_none=True)
        # the loss is a root on the last stage only (masked elsewhere); every
        # hop's result is a root with a zero gradient on every stage
        roots = ([ce] if last else []) + hops
        torch.autograd.backward(roots, [torch.ones_like(r) if r is ce else torch.zeros_like(r)
                                        for r in roots])
        for p in net.shared_parameters():  # each stage's share of the replicas' gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            all_reduce_(p.grad, stage_group)
        average_gradients(net.parameters(), data.group)
        state.optimizer.step()
        state.step += 1
        correct = (logits.detach().argmax(dim=-1) == y).sum()
        loss, correct = reduce_metrics(ce, correct)
        return state, loss, correct

    @torch.no_grad()
    def eval_step(state, images, labels):
        net = state.model
        net.eval()
        logits, _ = pp_logits(net, images[data.rows(images.shape[0])])
        logits = all_reduce_(logits if last else torch.zeros_like(logits), stage_group)
        logits = gather_rows(logits, data.group)
        loss = cross_entropy_loss(logits, labels)
        return loss, (logits.argmax(dim=-1) == labels).sum(), logits

    return train_step, eval_step


def pipeline_params_to_canonical(state: TrainState, mesh: DeviceMesh) -> dict:
    """The canonical ViT state dict of a pipeline state, its stages' blocks
    gathered over the stage group, on every rank (for ``save_model`` and the
    single-device predicts)."""
    net = state.model
    k = len(net.blocks)
    local = {name: torch.stack([b.state_dict()[name] for b in net.blocks])
             for name in net.blocks[0].state_dict()}
    stacked = {name: gather_rows(a, mesh.get_group(STAGE_AXIS)).reshape(-1, k, *a.shape[1:])
               for name, a in local.items()}
    return merge_vit_params(dict(net.vit.state_dict()), stacked)
