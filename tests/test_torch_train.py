"""The port's training path against the JAX package's, on the CPU, at small
size: the same numpy-seeded inputs and the same weights, converted flax →
torch, through both.

* ``cross_entropy_loss`` with and without label smoothing vs the JAX one
  (float32, within 1e-6 relative), ``accuracy``, and the learning-rate
  schedules (plain Python in both: equal).
* One and two Adam / AdamW updates from the same injected gradients vs
  optax's ``inject_hyperparams(adam|adamw)`` (within 1e-6 of the parameter
  scale: torch and optax round the same update in another order).
* Train mode, float32: loss, every parameter's gradient and the BatchNorm
  running statistics of a narrow ViT (conv stem, patch 8, 32² input) and a
  narrow ResNet-18 (s2d stem at 32², imagenet stem at 64² so that its last
  stage still sees 2×2 positions) vs ``jax.value_and_grad`` of the flax
  model with ``mutable=["batch_stats"]``. Loss within 1e-5 relative; each
  gradient within 2e-4 of its largest element (readings: ViT 5e-6, ResNet
  5e-5 to 7.5e-5: train-mode BatchNorm over 4 images amplifies the convs'
  other summation order); running statistics within 1e-5 relative. torch's
  own BatchNorm fails the running variance check (it keeps the unbiased
  batch variance), the flax one in ``models/resnet.py`` passes it.
* Whole epochs: ``make_fused_epoch`` with ``augment=False`` over a pure
  sample source (the same uint8 batch every step), 3 steps, vs the JAX
  ``make_fused_epoch``: the losses within 1e-5 relative, the correct counts
  equal, and the final parameters and BatchNorm statistics within 5e-5
  (readings: 5e-7 and 7e-6). The ResNet runs at 64² here: at 32² its last
  stage normalises 4 numbers a channel, and three SGD steps amplify a 4e-5
  gradient difference into 1 % of the loss.
  Both take plain SGD (``tx``): Adam turns a gradient of rounding noise into
  a step of ±lr, and the key bias's gradient is exactly zero (softmax
  ignores a constant added to a row), so its elements would differ by up to
  2·lr a step; the Adam update is held to optax above.

oneDNN is switched off for these tests: its CPU backward of the ResNet's
channels_last convs corrupts memory at some shapes in this torch build
(``double free or corruption`` at 64² with 4 images; the tree before this
change crashes the same way). The port's training runs on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _random_variables

from deephisto_tpu.models.patch_cls_simple.train import make_fused_epoch as jax_fused_epoch
from deephisto_tpu.models.resnet import ResNet18 as JResNet18
from deephisto_tpu.models.vit import ViT as JViT
from deephisto_tpu.train import create_train_state as jax_create_train_state
from deephisto_tpu.train import cross_entropy_loss as jax_ce
from deephisto_tpu.train import state as jax_state
from deephisto_tpu_torch.models import ResNet18, ViT, flax_resnet_to_torch, flax_vit_to_torch
from deephisto_tpu_torch.models.patch_cls_simple import make_fused_epoch, make_fused_eval, make_steps
from deephisto_tpu_torch.models.resnet import BatchNorm
from deephisto_tpu_torch.train import (
    ReduceLROnPlateau,
    WarmupCosine,
    accuracy,
    create_train_state,
    cross_entropy_loss,
    make_scheduler,
    set_learning_rate,
)

SIZE = 32
VIT = dict(num_classes=5, patch=8, dim=64, depth=2, heads=2)
CASES = [("vit", "conv", 32), ("resnet", "s2d", 32), ("resnet", "imagenet", 64)]


@pytest.fixture(autouse=True)
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _models(arch, stem, seed=0, size=SIZE):
    """(flax module, random numpy variables, the port's float32 model with
    them converted, the converter)."""
    if arch == "vit":
        jm = JViT(dtype=jnp.float32, stem=stem, **VIT)
        tm = ViT(dtype=torch.float32, stem=stem, img_size=size, **VIT)
        convert = flax_vit_to_torch
    else:
        jm = JResNet18(num_classes=5, num_filters=8, dtype=jnp.float32, stem=stem)
        tm = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32, stem=stem)
        convert = flax_resnet_to_torch
    shapes = jax.eval_shape(jm.init, jax.random.key(seed), jnp.zeros((1, size, size, 3)))
    v = _random_variables(shapes, np.random.default_rng(seed))
    tm.load_state_dict(convert(v))
    return jm, v, tm, convert


def _batch(n=4, seed=1, size=SIZE):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return u8, rng.integers(0, 5, n).astype(np.int32)


def _close_rel(got: torch.Tensor, want: np.ndarray, rel: float, name=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_cross_entropy_matches_jax(eps):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(16, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 16).astype(np.int32)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), eps))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), eps)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    acc = accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(acc) == pytest.approx(float((logits.argmax(-1) == labels).mean()))


def test_schedules_match_jax():
    cfgs = [{"lr": 1e-3}, {"lr": 3e-4, "schedule": "warmup_cosine", "n_epochs": 9,
                           "warmup_epochs": 2, "min_lr": 1e-5}]
    metric = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.0, 0.5]
    for cfg in cfgs:
        a, b = make_scheduler(cfg), jax_state.make_scheduler(cfg)
        assert type(a).__name__ == type(b).__name__
        assert [a.step(m) for m in metric] == [b.step(m) for m in metric]
        assert a.get_last_lr() == b.get_last_lr()
    with pytest.raises(ValueError, match="unknown training.schedule"):
        make_scheduler({"lr": 1.0, "schedule": "step"})
    assert isinstance(make_scheduler({"lr": 1.0}), ReduceLROnPlateau)
    w = WarmupCosine(1.0, total_epochs=4, warmup_epochs=0)
    assert w.lr == 1.0 and w.step() < 1.0


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adam_updates_match_optax(wd):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    grads = [(rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32))
             for _ in range(2)]

    class _Apply:  # flax TrainState needs an apply_fn; the update never calls it
        apply = None

    jstate = jax_create_train_state(
        _Apply(), {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}, 1e-2, weight_decay=wd)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    state = create_train_state(lin, 1e-2, weight_decay=wd)
    assert type(state.optimizer).__name__ == ("AdamW" if wd else "Adam")
    for gw, gb in grads:
        jstate = jstate.apply_gradients(grads={"w": jnp.asarray(gw), "b": jnp.asarray(gb)})
        lin.weight.grad, lin.bias.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        state.optimizer.step()
        for got, want in ((lin.weight, jstate.params["w"]), (lin.bias, jstate.params["b"])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    set_learning_rate(state, 5e-3)
    assert all(g["lr"] == 5e-3 for g in state.optimizer.param_groups)


def _flax_train_grads(jm, v, x, labels, eps):
    def loss_fn(params):
        logits, updates = jm.apply({"params": params, "batch_stats": v.get("batch_stats", {})},
                                   x, train=True, mutable=["batch_stats"])
        return jax_ce(logits, labels, eps), updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return float(loss), grads, updates


@pytest.mark.parametrize("arch,stem,size", CASES)
def test_train_mode_loss_grads_and_bn_stats_match_flax(arch, stem, size):
    jm, v, tm, convert = _models(arch, stem, size=size)
    u8, labels = _batch(size=size)
    x = u8.astype(np.float32) / 255.0
    loss_j, grads_j, updates = _flax_train_grads(jm, v, jnp.asarray(x), jnp.asarray(labels), 0.1)
    tm.train()
    loss = cross_entropy_loss(tm(torch.from_numpy(x)), torch.from_numpy(labels), 0.1)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(loss_j, rel=1e-5)
    want = convert({"params": jax.tree.map(np.array, grads_j)})
    params = dict(tm.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        _close_rel(params[name].grad, g.numpy(), 2e-4, name)
    stats = convert({"params": {}, "batch_stats": jax.tree.map(np.array, updates["batch_stats"])})
    buffers = dict(tm.named_buffers())
    for name, s in stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        _close_rel(buffers[name], s.numpy(), 1e-5, name)
        assert not np.allclose(s.numpy(), convert(v)[name].numpy())  # the batch moved them


def test_torch_batchnorm_running_var_differs_from_flax():
    """The fault the port's BatchNorm repairs: torch's ``nn.BatchNorm2d``
    feeds the running variance the unbiased batch variance; flax the biased
    one, which the port's BatchNorm matches."""
    import flax.linen as fnn

    x = np.random.default_rng(3).normal(size=(2, 3, 3, 4)).astype(np.float32)  # NHWC, n = 18
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    _, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours, theirs = BatchNorm(4).train(), torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    ours(xt), theirs(xt)
    np.testing.assert_allclose(ours.running_var.numpy(), want, rtol=1e-5)
    assert not np.allclose(theirs.running_var.numpy(), want, rtol=1e-3)


@pytest.mark.parametrize("arch,stem,size", [("resnet", "s2d", 64), ("vit", "conv", 32)])
def test_fused_epoch_matches_jax(arch, stem, size):
    """3 steps of ``make_fused_epoch`` (SGD 0.05, label smoothing 0.1, no
    augmentation) over the same uint8 batch in both packages."""
    jm, v, tm, convert = _models(arch, stem, seed=4, size=size)
    u8, labels = _batch(seed=5, size=size)
    coords = np.zeros((len(labels), 2), np.int32)
    steps = 3

    def jax_source(key):
        return jnp.asarray(u8), jnp.asarray(labels), jnp.asarray(coords), jnp.zeros(4, jnp.int32)

    import optax

    lr = 0.05
    jstate = jax_create_train_state(jm, jax.tree.map(jnp.asarray, v), lr, tx=optax.sgd(lr))
    jepoch = jax_fused_epoch(jm, jax_source, 4, steps, augment=False, label_smoothing=0.1)
    jstate, jlosses, jcorrects = jepoch(jstate, jax.random.key(0))

    def torch_source(gen):
        return (torch.from_numpy(u8), torch.from_numpy(labels), torch.from_numpy(coords),
                torch.zeros(4, dtype=torch.int32))

    state = create_train_state(tm, lr, tx=torch.optim.SGD(tm.parameters(), lr=lr))
    epoch = make_fused_epoch(tm, torch_source, 4, steps, augment=False, label_smoothing=0.1)
    state, losses, corrects = epoch(state, torch.Generator().manual_seed(0))
    assert state.step == steps and losses.shape == (steps,) and corrects.dtype == torch.int64
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_array_equal(corrects.numpy(), np.asarray(jcorrects))
    want = convert({"params": jax.tree.map(np.array, jstate.params),
                    "batch_stats": jax.tree.map(np.array, jstate.batch_stats)})
    got = dict(tm.named_parameters()) | dict(tm.named_buffers())
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), rtol=0, atol=5e-5,
                                       err_msg=name)


def test_eval_and_steps_run_on_the_cpu():
    _, _, tm, _ = _models("resnet", "s2d", seed=6)
    u8, labels = _batch(seed=7)
    x, y = torch.from_numpy(u8).float() / 255.0, torch.from_numpy(labels)
    state = create_train_state(tm, 1e-3, weight_decay=0.01)
    train_step, eval_step = make_steps(tm)
    state, loss, correct = train_step(state, x, y)
    assert state.step == 1 and torch.isfinite(loss) and 0 <= int(correct) <= 4
    eloss, ecorrect, logits = eval_step(state, x, y)
    assert logits.shape == (4, 5) and not tm.training

    def source(gen):
        return torch.from_numpy(u8), y, None, None

    losses, corrects = make_fused_eval(tm, source, 4, 2)(state, torch.Generator().manual_seed(1))
    torch.testing.assert_close(losses, torch.stack([eloss, eloss]))
    assert corrects.tolist() == [int(ecorrect)] * 2


def test_inference_weight_casts_follow_the_weights():
    """Under inference mode the bf16 casts of the float32 weights are kept
    between calls (``models/resnet.py:cast_param``) and made again when an
    optimizer step changes the weights; outside it every call casts."""
    from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model

    m = init_model(get_model(5, arch="vit", depth=1, input_size=32), seed=0).eval()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        first = m(x)
        assert torch.equal(m(x), first)
    with torch.no_grad():
        assert torch.equal(m(x), first)
    state = create_train_state(m, 1e-2)
    train_step, _ = make_steps(m)
    train_step(state, x, torch.tensor([0, 1]))
    m.eval()
    with torch.inference_mode():
        after = m(x)
    with torch.no_grad():
        assert torch.equal(m(x), after)
    assert not torch.equal(after, first)
