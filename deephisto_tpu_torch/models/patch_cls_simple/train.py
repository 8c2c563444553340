"""Patch-classifier training program, a port of
``deephisto_tpu/models/patch_cls_simple/train.py``: the epoch, eval and step
functions (``make_fused_epoch``, ``make_fused_eval``, ``make_steps``) and the
program around them (``train(cfg)``, ``main``: test-set extraction, epochs
with validation and test evaluation, the best-model and resume checkpoints
in the JAX package's flax msgpack format, ``metrics.csv`` and the plots).

Run it as ``python -m deephisto_tpu_torch.models.patch_cls_simple.train
[--extract_test] [--resume] [--config X.yaml]``, or data parallel as
``torchrun --nproc_per_node=N -m deephisto_tpu_torch.models.patch_cls_simple.train
...`` (one card a rank, over NCCL; ranks that share a card join a gloo
group themselves, ``parallel.initialize(backend="gloo")``, and call
:func:`train`).

Data parallelism (``mesh=``, ``parallel/__init__.py``): every rank draws
the same global batch from the same seeded generators and takes its rows,
so the trajectory is single-device training's, as the JAX package shards
one global batch. BatchNorm takes the global batch's statistics
(``models/resnet.py:BatchNorm``); after the backward one all-reduce over
the ``data`` group averages the gradients (an explicit reduce, not
``DistributedDataParallel``: the state keeps the model itself, so the
checkpoints and predicts take it as they are, and the same reduce serves a
tensor-parallel ViT, whose MLP shards differ across the ``model`` axis;
its replicated parameters then take the gradients of the ``model`` group's
first rank, one broadcast, so that their copies stay bit-equal); the losses and correct counts are reduced over the ranks. Rank 0 alone
writes files and prints.

The JAX epoch is one ``lax.scan`` program; here it is a Python loop that
queues every step on the device and keeps each step's loss and correct
count in device tensors, read back to the host once per epoch, after the
loop: the loop itself calls no ``.item()`` and never waits for the card.
A step runs, in the JAX body's order (``train_core``): the uint8 random crop
and flips, ``/ 255`` in float32, the forward in train mode (BatchNorm
statistics update as flax's), the cross-entropy, the backward, the
optimizer step.

Randomness: ``epoch_fn(state, gen)`` takes a CPU ``torch.Generator`` (the
JAX epoch's key), from which it draws two seeds per step on the host; they
seed the step's device generators for sampling and for augmentation, as the
JAX epoch splits its key into per-step (sample, augment) keys. So the
presampled path (all coordinates sampled before the loop) and the per-step
path draw the same coordinates from the same generator state. ``train``
seeds each epoch's generators from ``(training.seed, epoch)``, as the JAX
trainer folds the epoch into its key, so a resumed run draws the batches of
an uninterrupted one.

Deliberate deviations, forced by the machine with the card (no PIL, no
matplotlib): the extracted test set is PNG, not JPEG (lossless, so it holds
the sampled pixels exactly; the JAX reader reads it too), and ``loss.jpg`` /
``acc.jpg`` are written only where matplotlib is importable (otherwise the
trainer says once that it skipped them; ``metrics.csv`` holds the same
numbers). Validation runs without the training augmentations, as in the JAX
trainer.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ..._device import resolve_device
from ...samplers import AnnoRegionRndSampler, extract_and_save_subset
from ...train import (
    BEST_MODEL_FILE,
    create_train_state,
    load_train_state,
    make_scheduler,
    save_model,
    save_train_state,
    set_learning_rate,
)
from ...train.metrics import cross_entropy_loss
from ...train.state import TrainState
from ...utils import get_img_ano_paths, resolve_dataset
from ..resnet import sync_batchnorm
from . import utils
from .model import get_model, init_model

CONFIG_PATH = Path(__file__).with_name("config.yaml")
METRICS_HEADER = ("epoch,train_loss,train_acc,val_loss,val_acc,test_loss,test_acc,lr,"
                  "patches_per_s\n")


def save_plot(train_values, val_values, test_values, title, filename, out_dir) -> bool:
    """Plot the three curves to ``out_dir/filename``; False (nothing written)
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.figure()
    plt.plot(train_values, label="train")
    plt.plot(val_values, label="val")
    plt.plot(test_values, label="test")
    plt.title(title)
    plt.xlabel("Epoch")
    plt.legend()
    plt.savefig(Path(out_dir) / filename)
    plt.close()
    return True


def prepare_test_patches(cfg, device=None):
    """Extract the test set (``cfg["test"]``) from the dataset's test slides
    into an ImageFolder of PNG patches, replacing any earlier one."""
    ds_folder = resolve_dataset(cfg["dataset"]["folder"])
    img_anno_paths_test = get_img_ano_paths(ds_folder, sample="test")

    out_dir = Path(cfg["test"]["dir"])
    if out_dir.exists() and out_dir.is_dir():
        shutil.rmtree(out_dir)

    extract_and_save_subset(
        img_anno_paths=img_anno_paths_test,
        out_folder=out_dir,
        patch_size=cfg["dataset"]["patch_size"],
        layer=cfg["dataset"]["layer"],
        patches_per_class=cfg["test"]["samples_per_class"],
        device=device,
    )


def _is_sampler(source) -> bool:
    return hasattr(source, "make_sample_fn")


def _step_generators(gen: torch.Generator, n_steps: int, device) -> list:
    """Per-step (sample, augment) device generators, seeded from ``gen`` on
    the host."""
    seeds = torch.randint(0, 2**62, (n_steps, 2), generator=gen).tolist()
    return [
        (torch.Generator(device).manual_seed(a), torch.Generator(device).manual_seed(b))
        for a, b in seeds
    ]


def _device_of(state: TrainState, source) -> torch.device:
    if _is_sampler(source):
        return source.device
    return next(state.model.parameters()).device


class _DataParallel:
    """What the steps need of a mesh: this rank's rows of a global batch,
    the BatchNorm statistics over the ``data`` group, the gradient and
    metric reductions. Without a mesh every operation is the identity."""

    def __init__(self, mesh):
        from ...parallel.mesh import MODEL_AXIS, axis_size, batch_sharding

        self.shard = batch_sharding(mesh) if mesh is not None else None
        self.model_group = (mesh.get_group(MODEL_AXIS)
                            if mesh is not None and MODEL_AXIS in (mesh.mesh_dim_names or ())
                            and axis_size(mesh, MODEL_AXIS) > 1 else None)

    def rows(self, n: int) -> slice:
        return self.shard.rows(n) if self.shard else slice(0, n)

    def prepare(self, net) -> None:
        """BatchNorm's statistics over the data group (without a mesh, each
        call's own batch, whatever an earlier mesh set). Called once, when
        the steps are made: the last steps made for a model set its group."""
        sync_batchnorm(net, self.shard.group if self.shard else None)

    def sync_gradients(self, net) -> None:
        """Average the gradients over the data group; then, with a ``model``
        axis, give the replicated parameters the gradients of the model
        group's first rank, so that their copies stay bit-equal."""
        if self.shard:
            from ...parallel._comm import average_gradients

            average_gradients(net.parameters(), self.shard.group)
        if self.model_group is not None:
            from ...parallel.tensor import broadcast_replicated_gradients

            broadcast_replicated_gradients(net, self.model_group)

    def mean_sum(self, losses, corrects):
        """The data group's mean of ``losses`` and sum of ``corrects``."""
        if not self.shard:
            return losses, corrects
        from ...parallel._comm import all_reduce_

        return (all_reduce_(losses.clone(), self.shard.group) / self.shard.count,
                all_reduce_(corrects.clone(), self.shard.group))

    def gather(self, x):
        if not self.shard:
            return x
        from ...parallel._comm import gather_rows

        return gather_rows(x, self.shard.group)


def make_fused_epoch(
    model,
    sample_source,
    batch_size,
    n_steps,
    mesh=None,
    augment=True,
    crop_pad=0,
    label_smoothing=0.0,
    presample_chunk=8,
):
    """The training epoch: sampling + augmentation + forward/backward +
    update for ``n_steps`` steps, queued on the device with one read back.
    ``sample_source`` is an :class:`AnnoRegionRndSampler` or a function
    ``gen -> (patches_u8, labels, coords, img_idx)`` of a device generator.
    Returns ``epoch_fn(state, gen) -> (state, losses, corrects)``: ``gen`` a
    CPU ``torch.Generator``, ``losses`` (n_steps,) float32 and ``corrects``
    (n_steps,) int64 CPU tensors; ``state`` is updated in place.

    ``crop_pad > 0``: the sampler gathers ``patch_size + 2*crop_pad``
    windows and each sample is cropped back to ``patch_size`` at a uniform
    per-sample offset. ``augment``: one horizontal and one vertical flip
    coin per batch. ``label_smoothing`` goes to the CE loss.

    ``presample_chunk``: with a sampler, the coordinates of all steps are
    sampled before the loop, ``presample_chunk`` steps' rejection trials in
    one batch (the same coordinates as the per-step path); 0/None samples
    per step. ``model`` is the model the state holds; a
    ``ContextWindowModel`` (``model.context`` > 0) gets context windows from
    the sampler, and cannot be combined with ``crop_pad`` (both repurpose the
    context gather).

    ``mesh``: data parallel (module docstring), every rank calling
    ``epoch_fn`` with the same state and generator; each rank gathers and
    trains on its rows of every global batch (the crop offsets drawn for the
    global batch), and returns the global losses and correct counts."""
    if crop_pad < 0:
        raise ValueError("crop_pad must be non-negative")
    model_ctx = getattr(model, "context", 0)
    if crop_pad and model_ctx:
        raise ValueError("crop_pad augmentation and a ContextWindowModel both "
                         "repurpose the context gather; use one or the other")
    gather_ctx = model_ctx + crop_pad
    is_sampler = _is_sampler(sample_source)
    presample = bool(presample_chunk) and is_sampler
    if is_sampler:
        sample_fn = sample_source.make_sample_fn(batch_size, context=gather_ctx)
        gather_fn = sample_source.make_gather_fn(context=gather_ctx)
    else:
        sample_fn = sample_source

    dp = _DataParallel(mesh)
    dp.prepare(model)
    rows = dp.rows(batch_size)

    def train_core(state, patches, labels, gen_aug):
        """augment (u8: flips commute with the /255 cast exactly) + cast +
        fwd/bwd + update. Shared by the per-step and presampled paths.
        ``patches`` and ``labels`` are this rank's rows."""
        dev = patches.device
        if crop_pad:
            b = patches.shape[0]
            size = patches.shape[1] - 2 * crop_pad
            offs = torch.randint(0, 2 * crop_pad + 1, (batch_size, 2), generator=gen_aug,
                                 device=dev)[rows]
            r = torch.arange(size, device=dev)
            ys = (offs[:, 0, None] + r)[:, :, None]
            xs = (offs[:, 1, None] + r)[:, None, :]
            patches = patches[torch.arange(b, device=dev)[:, None, None], ys, xs]
        if augment:
            flip_h = torch.rand((), generator=gen_aug, device=dev) < 0.5
            flip_v = torch.rand((), generator=gen_aug, device=dev) < 0.5
            patches = torch.where(flip_h, patches.flip(2), patches)
            patches = torch.where(flip_v, patches.flip(1), patches)
        x = patches.float() / 255.0
        net = state.model
        net.train()
        logits = net(x)
        loss = cross_entropy_loss(logits, labels, label_smoothing)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dp.sync_gradients(net)
        state.optimizer.step()
        state.step += 1
        correct = (logits.detach().argmax(dim=-1) == labels).sum()
        return loss.detach(), correct

    def epoch(state, gen):
        dev = _device_of(state, sample_source)
        gens = _step_generators(gen, n_steps, dev)
        losses = torch.empty(n_steps, dtype=torch.float32, device=dev)
        corrects = torch.empty(n_steps, dtype=torch.int64, device=dev)
        if presample:
            parts = [
                sample_source.sample_coords([g for g, _ in gens[c0:c0 + presample_chunk]],
                                            batch_size)
                for c0 in range(0, n_steps, presample_chunk)
            ]
            labels, coords, img_idx = (torch.cat(x) for x in zip(*parts))
        for s in range(n_steps):
            if presample:
                patches = gather_fn(img_idx[s][rows], coords[s][rows])
                lab = labels[s][rows]
            else:
                patches, lab, _, _ = sample_fn(gens[s][0])
                patches, lab = patches[rows], lab[rows]
            losses[s], corrects[s] = train_core(state, patches, lab, gens[s][1])
        losses, corrects = dp.mean_sum(losses, corrects)
        return state, losses.cpu(), corrects.cpu()

    return epoch


def make_fused_eval(model, sample_source, batch_size, n_steps):
    """Validation pass: ``eval_fn(state, gen) -> (losses, corrects)`` over
    ``n_steps`` batches sampled as in :func:`make_fused_epoch`, the model in
    eval mode, read back once."""
    sample_fn = (sample_source.make_sample_fn(batch_size, context=getattr(model, "context", 0))
                 if _is_sampler(sample_source) else sample_source)

    @torch.no_grad()
    def evaluate(state, gen):
        dev = _device_of(state, sample_source)
        gens = _step_generators(gen, n_steps, dev)
        losses = torch.empty(n_steps, dtype=torch.float32, device=dev)
        corrects = torch.empty(n_steps, dtype=torch.int64, device=dev)
        net = state.model
        net.eval()
        for s in range(n_steps):
            patches, labels, _, _ = sample_fn(gens[s][0])
            logits = net(patches.float() / 255.0)
            losses[s] = cross_entropy_loss(logits, labels)
            corrects[s] = (logits.argmax(dim=-1) == labels).sum()
        return losses.cpu(), corrects.cpu()

    return evaluate


def make_steps(model, mesh=None):
    """The train and eval steps on float batches: ``train_step(state, images,
    labels) -> (state, loss, correct)`` and ``eval_step(state, images,
    labels) -> (loss, correct, logits)``, all on the device.

    ``mesh``: every rank is handed the same global batch and takes its rows
    of the ``data`` axis; BatchNorm takes the global batch's statistics, the
    gradients are averaged over the ``data`` group, and the loss, the count
    and (eval) the logits are the global batch's on every rank. A
    tensor-parallel ViT (``parallel.place_vit_tensor_parallel``) trains on
    the same steps with a mesh that has a ``model`` axis."""
    dp = _DataParallel(mesh)
    dp.prepare(model)

    def train_step(state, images, labels):
        rows = dp.rows(images.shape[0])
        images, labels = images[rows], labels[rows]
        net = state.model
        net.train()
        logits = net(images)
        loss = cross_entropy_loss(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dp.sync_gradients(net)
        state.optimizer.step()
        state.step += 1
        loss, correct = dp.mean_sum(loss.detach(), (logits.detach().argmax(dim=-1) == labels).sum())
        return state, loss, correct

    @torch.no_grad()
    def eval_step(state, images, labels):
        net = state.model
        net.eval()
        logits = dp.gather(net(images[dp.rows(images.shape[0])]))
        return cross_entropy_loss(logits, labels), (logits.argmax(dim=-1) == labels).sum(), logits

    return train_step, eval_step


def append_metrics(path: Path, row: str, fresh: bool) -> None:
    """Append one epoch's row to ``metrics.csv``, writing the header first
    when the file is missing or ``fresh`` (the first epoch of a run that does
    not resume)."""
    if fresh or not path.exists():
        path.write_text(METRICS_HEADER)
    with path.open("a") as f:
        f.write(row)


def _epoch_generators(seed: int, epoch: int) -> tuple[torch.Generator, torch.Generator]:
    """The epoch's (train, val) CPU generators, a function of ``(seed,
    epoch)`` only, as the JAX trainer's ``split(fold_in(key, epoch))``."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2)
    return torch.Generator().manual_seed(int(a)), torch.Generator().manual_seed(int(b))


def _test_pass(state, eval_step, images, labels, batch_size):
    """The test set in fixed-shape batches, the last one padded by repeating
    its final patch and the padding masked out; the card's logits are read
    back once. Returns (loss, accuracy): per-sample max-subtracted CE (float32
    stable at confident logits) and accuracy over the real samples."""
    n = images.shape[0]
    logits_all = []
    for s in range(0, n, batch_size):
        imgs, labs = images[s:s + batch_size], labels[s:s + batch_size]
        pad = batch_size - imgs.shape[0]
        if pad:  # pad to fixed shape, mask the tail
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
            labs = torch.cat([labs, labs[-1:].expand(pad)])
        _, _, logits = eval_step(state, imgs.float() / 255.0, labs)
        logits_all.append(logits[:batch_size - pad])
    logits_np = torch.cat(logits_all).float().cpu().numpy()
    labels_np = labels.cpu().numpy()
    test_loss, correct = 0.0, 0
    for s in range(0, n, batch_size):
        lv, lab = logits_np[s:s + batch_size], labels_np[s:s + batch_size]
        correct += int((np.argmax(lv, -1) == lab).sum())
        m = lv.max(-1, keepdims=True)
        lse = m[:, 0] + np.log(np.exp(lv - m).sum(-1))
        test_loss += float((lse - lv[np.arange(len(lab)), lab]).sum())
    return test_loss / max(n, 1), correct / max(n, 1)


def train(cfg, resume: bool = False, mesh=None, device=None):
    """Train per ``cfg`` (the JAX trainer's config schema) on ``device`` (the
    current CUDA device by default; ``"cpu"`` runs the plain versions).
    Writes ``best_model.msgpack``, ``metrics.csv`` and the plots to
    ``training.out_dir`` and ``last_state.msgpack`` to ``training.save_dir``
    every epoch; ``resume`` continues from ``last_state.msgpack``. Returns
    the per-epoch losses and accuracies.

    ``mesh``: data parallel over its ``data`` axis (module docstring), every
    rank calling with the same config; under torchrun (``WORLD_SIZE`` > 1)
    with no mesh, the trainer joins the process group (``parallel.initialize``)
    and makes a mesh of every rank itself, as the JAX trainer does when it
    sees more than one device. Rank 0 alone writes the files."""
    from ...parallel import initialize, make_mesh, replicated

    if mesh is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize()
        mesh = make_mesh()
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    log = print if rank0 else _silent
    device = utils.get_device() if device is None else resolve_device(device)
    log(f"Using device: {device}")
    if mesh is not None:
        log(f"Data-parallel over {mesh.size()} ranks: mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    save_dir = Path(cfg["training"]["save_dir"])
    save_dir.mkdir(parents=True, exist_ok=True)
    out_dir = Path(cfg["training"]["out_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)

    ds_folder = resolve_dataset(cfg["dataset"]["folder"])
    img_anno_paths_train = get_img_ano_paths(ds_folder, sample="train")

    # multi-mag banks are created first so the region sampler can share the
    # base-layer bank instead of staging the same layer twice
    mm_layers = cfg["dataset"].get("multi_mag_layers")
    mm_bank = None
    shared_bank = None
    if mm_layers:
        from ...samplers.multimag import MultiMagBank

        mm_bank = MultiMagBank([p for p, _ in img_anno_paths_train], tuple(mm_layers),
                               device=device)
        shared_bank = mm_bank.banks.get(cfg["dataset"]["layer"])

    train_val_dataset = AnnoRegionRndSampler(
        img_anno_paths_train,
        patch_size=cfg["dataset"]["patch_size"],
        layer=cfg["dataset"]["layer"],
        patches_from_one_region=cfg["dataset"]["patches_from_one_region"],
        one_image_for_batch=cfg["training"]["one_image_for_batch"],
        slide_bank=shared_bank,
        device=device,
    )
    n_classes = cfg["model"]["n_classes"]
    if len(train_val_dataset.classes) != n_classes:
        log(
            f"note: dataset has {len(train_val_dataset.classes)} classes, "
            f"config says {n_classes}; using config."
        )

    # test set (ImageFolder extracted by --extract_test)
    test_dir = Path(cfg["test"]["dir"])
    test_data = None
    if test_dir.is_dir():
        test_images, test_labels, _ = utils.load_image_folder(test_dir)
        test_data = (test_images, test_labels)
    else:
        log(f"test dir {test_dir} missing — run with --extract_test first; "
              "skipping test evaluation.")

    # multi-magnification configuration: patches from several pyramid layers
    # stacked on the channel axis
    sample_source = train_val_dataset
    in_channels = 3
    if mm_layers:
        from ...samplers.multimag import make_multimag_sample_fn

        sample_source = make_multimag_sample_fn(
            train_val_dataset, mm_bank, cfg["training"]["batch_size"]
        )
        in_channels = 3 * len(mm_layers)
        if test_data is not None:
            log("note: test-set evaluation is single-magnification only; "
                  "skipping it for the multi-mag configuration.")
            test_data = None

    # model + state. model.context > 0 trains the way fcn mode serves
    # (context.py): labels stay per-patch, pixels are the patch + its real
    # surroundings, the head reads the center feature block
    context = cfg["model"].get("context", 0)
    if context < 0 or context % 32:
        raise ValueError("model.context must be a non-negative multiple of 32")
    arch = cfg["model"].get("arch", "resnet")
    model = get_model(
        n_classes,
        depth=cfg["model"].get("depth", 18),
        stem=cfg["model"].get("stem", "imagenet"),
        arch=arch,
        width=cfg["model"].get("width", 1),
        patch=cfg["model"].get("patch", 16),  # ViT token size
        input_size=cfg["dataset"]["patch_size"] + 2 * context,
        in_channels=in_channels,
    )
    init_model(model, pretrained=in_channels == 3 and arch == "resnet")
    model = model.to(device)
    train_model = model
    if context:
        if mm_layers:
            raise ValueError("model.context is single-magnification only")
        if arch != "resnet":
            raise ValueError("model.context requires a ResNet-family backbone")
        from .context import ContextWindowModel

        train_model = ContextWindowModel(
            model, patch_size=cfg["dataset"]["patch_size"], context=context
        )
        log(f"Context-consistent training: window = patch + 2*{context}")
        if test_data is not None:
            # disk test patches are bare patch_size crops; edge-replicate the
            # surroundings ONCE (fcn serving's slide-border halo convention)
            test_images, test_labels = test_data
            test_images = np.pad(
                test_images,
                ((0, 0), (context, context), (context, context), (0, 0)),
                mode="edge",
            )
            test_data = (test_images, test_labels)
    if test_data is not None:  # to the device once, as uint8
        test_data = (torch.from_numpy(test_data[0]).to(device),
                     torch.from_numpy(test_data[1]).to(device))
    state = create_train_state(
        train_model,
        cfg["training"]["lr"],
        weight_decay=cfg["training"].get("weight_decay", 0.0),
    )
    if mesh is not None:
        replicated(state, mesh)

    scheduler = make_scheduler(cfg["training"])

    start_epoch = 0
    best_val_acc = 0.0
    last_ckpt = save_dir / "last_state.msgpack"
    if resume and last_ckpt.exists():
        state, start_epoch, extra = load_train_state(last_ckpt, state)
        best_val_acc = extra.get("best_val_acc", 0.0)
        scheduler.lr = extra.get("lr", scheduler.lr)
        if hasattr(scheduler, "best"):  # plateau state
            scheduler.best = extra.get("sched_best")
            scheduler.num_bad_epochs = extra.get("sched_bad_epochs", 0)
        if hasattr(scheduler, "epoch"):  # warmup_cosine state
            scheduler.epoch = extra.get("sched_epoch", start_epoch)
        log(f"Resumed from epoch {start_epoch} (best val acc {best_val_acc:.4f})")

    # schedules that don't start at the base LR (warmup) must be applied
    # before the first epoch, not only after scheduler.step()
    state = set_learning_rate(state, scheduler.lr)

    _, eval_step = make_steps(train_model, mesh)

    batch_size = cfg["training"]["batch_size"]
    train_steps = cfg["training"].get(
        "train_steps",
        len(train_val_dataset) // batch_size * cfg["training"]["augment_factor"],
    )
    val_steps = cfg["training"]["val_steps"]

    fused_epoch = make_fused_epoch(
        train_model, sample_source, batch_size, train_steps, mesh=mesh,
        crop_pad=cfg["training"].get("crop_pad", 0),
        label_smoothing=cfg["training"].get("label_smoothing", 0.0),
    )
    fused_eval = make_fused_eval(train_model, sample_source, batch_size, val_steps)
    seed = cfg["training"].get("seed", 0)

    train_losses, val_losses, test_losses = [], [], []
    train_accuracies, val_accuracies, test_accuracies = [], [], []

    for epoch in range(start_epoch, cfg["training"]["n_epochs"]):
        # ---- train (queued on the device, one read back) ----
        t0 = time.time()
        gen_train, gen_val = _epoch_generators(seed, epoch)
        state, losses, corrects = fused_epoch(state, gen_train)
        train_loss = float(losses.mean())
        n_train_patches = train_steps * batch_size
        train_acc = int(corrects.sum()) / n_train_patches
        train_losses.append(train_loss)
        train_accuracies.append(train_acc)
        dt = time.time() - t0
        train_pps = n_train_patches / dt
        log(
            f"Epoch {epoch + 1}/{cfg['training']['n_epochs']} "
            f"({train_pps:.0f} patches/s)"
        )
        log(f"Train Loss: {train_loss:.4f}, Train Acc: {train_acc:.4f}")

        # ---- val ----
        v_losses, v_corrects = fused_eval(state, gen_val)
        val_loss = float(v_losses.mean())
        val_acc = int(v_corrects.sum()) / (val_steps * batch_size)
        val_losses.append(val_loss)
        val_accuracies.append(val_acc)
        log(f"Val Loss: {val_loss:.4f}, Val Acc: {val_acc:.4f}")

        new_lr = scheduler.step(val_loss)
        state = set_learning_rate(state, new_lr)
        log(f"Current Learning Rate: {scheduler.get_last_lr()[0]:.6f}")

        if val_acc > best_val_acc:
            best_val_acc = val_acc
            if rank0:
                save_model(out_dir / BEST_MODEL_FILE, model)

        # ---- test ----
        if test_data is not None:
            test_loss, test_acc = _test_pass(state, eval_step, *test_data, batch_size)
            test_losses.append(test_loss)
            test_accuracies.append(test_acc)
            log(f"Test Loss: {test_loss:.4f}, Test Acc: {test_acc:.4f}")

        # ---- plots + metrics log + resume checkpoint (rank 0) ----
        if not rank0:
            continue
        plotted = save_plot(train_losses, val_losses, test_losses, "Loss", "loss.jpg", out_dir)
        save_plot(train_accuracies, val_accuracies, test_accuracies, "Acc", "acc.jpg", out_dir)
        if not plotted and epoch == start_epoch:
            log("matplotlib is not installed: loss.jpg and acc.jpg are skipped "
                  "(metrics.csv holds the same numbers)")
        t_loss = test_losses[-1] if test_losses else ""
        t_acc = test_accuracies[-1] if test_accuracies else ""
        append_metrics(
            out_dir / "metrics.csv",
            f"{epoch + 1},{train_loss:.6f},{train_acc:.6f},{val_loss:.6f},"
            f"{val_acc:.6f},{t_loss},{t_acc},{scheduler.lr:.2e},{train_pps:.0f}\n",
            fresh=epoch == start_epoch and not resume,
        )
        save_train_state(
            last_ckpt,
            state,
            epoch + 1,
            extra={
                "best_val_acc": best_val_acc,
                "lr": scheduler.lr,
                "sched_best": getattr(scheduler, "best", None),
                "sched_bad_epochs": getattr(scheduler, "num_bad_epochs", 0),
                "sched_epoch": getattr(scheduler, "epoch", epoch + 1),
            },
        )

    return {
        "train_losses": train_losses,
        "val_losses": val_losses,
        "test_losses": test_losses,
        "train_accuracies": train_accuracies,
        "val_accuracies": val_accuracies,
        "test_accuracies": test_accuracies,
        "best_val_acc": best_val_acc,
        "model": model,
    }


def _silent(*args, **kwargs) -> None:
    """``print`` on every rank but rank 0."""


def main(argv=None):
    # prefer a cwd-level config (the reference loads
    # ./models/patch_cls_simple/config.yaml relative to the repo root);
    # fall back to the packaged default
    cwd_config = Path("./models/patch_cls_simple/config.yaml")
    default_config = cwd_config if cwd_config.is_file() else CONFIG_PATH

    parser = argparse.ArgumentParser()
    parser.add_argument("--extract_test", action="store_true", default=False)
    parser.add_argument("--resume", action="store_true", default=False)
    parser.add_argument("--config", type=Path, default=default_config)
    args = parser.parse_args(argv)

    cfg = utils.load_config(args.config)

    from ...parallel import initialize

    multi = int(os.environ.get("WORLD_SIZE", "1")) > 1 and initialize()
    if args.extract_test:
        if not multi or torch.distributed.get_rank() == 0:
            prepare_test_patches(cfg)
        if multi:
            torch.distributed.barrier()

    return train(cfg, resume=args.resume)


if __name__ == "__main__":
    main()
