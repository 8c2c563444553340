"""Patch-classifier training, a port of the device half of
``deephisto_tpu/models/patch_cls_simple/train.py``: ``make_fused_epoch``,
``make_fused_eval`` and ``make_steps`` (single device; the JAX package's
``mesh=`` is not ported).

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
path draw the same coordinates from the same generator state.

The JAX trainer's ``train(cfg)`` CLI, its checkpoints and the
``ContextWindowModel`` are not ported yet (ROADMAP, queue A item 7).
"""

from __future__ import annotations

import torch

from ...train.metrics import cross_entropy_loss
from ...train.state import TrainState


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


def make_fused_epoch(
    model,
    sample_source,
    batch_size,
    n_steps,
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
    per step. ``model`` is the model the state holds."""
    if crop_pad < 0:
        raise ValueError("crop_pad must be non-negative")
    is_sampler = _is_sampler(sample_source)
    presample = bool(presample_chunk) and is_sampler
    if is_sampler:
        sample_fn = sample_source.make_sample_fn(batch_size, context=crop_pad)
        gather_fn = sample_source.make_gather_fn(context=crop_pad)
    else:
        sample_fn = sample_source

    def train_core(state, patches, labels, gen_aug):
        """augment (u8: flips commute with the /255 cast exactly) + cast +
        fwd/bwd + update. Shared by the per-step and presampled paths."""
        dev = patches.device
        if crop_pad:
            b = patches.shape[0]
            size = patches.shape[1] - 2 * crop_pad
            offs = torch.randint(0, 2 * crop_pad + 1, (b, 2), generator=gen_aug, device=dev)
            r = torch.arange(size, device=dev)
            rows = (offs[:, 0, None] + r)[:, :, None]
            cols = (offs[:, 1, None] + r)[:, None, :]
            patches = patches[torch.arange(b, device=dev)[:, None, None], rows, cols]
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
                patches, lab = gather_fn(img_idx[s], coords[s]), labels[s]
            else:
                patches, lab, _, _ = sample_fn(gens[s][0])
            losses[s], corrects[s] = train_core(state, patches, lab, gens[s][1])
        return state, losses.cpu(), corrects.cpu()

    return epoch


def make_fused_eval(model, sample_source, batch_size, n_steps):
    """Validation pass: ``eval_fn(state, gen) -> (losses, corrects)`` over
    ``n_steps`` batches sampled as in :func:`make_fused_epoch`, the model in
    eval mode, read back once."""
    sample_fn = (sample_source.make_sample_fn(batch_size) if _is_sampler(sample_source)
                 else sample_source)

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


def make_steps(model):
    """The train and eval steps on float batches: ``train_step(state, images,
    labels) -> (state, loss, correct)`` and ``eval_step(state, images,
    labels) -> (loss, correct, logits)``, all on the device."""

    def train_step(state, images, labels):
        net = state.model
        net.train()
        logits = net(images)
        loss = cross_entropy_loss(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), (logits.detach().argmax(dim=-1) == labels).sum()

    @torch.no_grad()
    def eval_step(state, images, labels):
        net = state.model
        net.eval()
        logits = net(images)
        return cross_entropy_loss(logits, labels), (logits.argmax(dim=-1) == labels).sum(), logits

    return train_step, eval_step
