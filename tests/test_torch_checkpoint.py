"""The port's checkpoints against the JAX package's, on the CPU: they are one
file format, flax's msgpack.

* The codec (``train/_msgpack.py``) writes the bytes of
  ``flax.serialization.msgpack_serialize`` for the same tree (seeded
  ResNet-18 and ViT variables, optax adam and adamw state dicts, an
  ``extra`` of None, float, int and str), and reads what it wrote as
  ``msgpack_restore`` does, the chunked form of large arrays included
  (``MAX_CHUNK_SIZE`` made small in both for the test). Exact.
* Weights both ways: a JAX ``save_model`` file read by the port gives the
  flax model's logits (float32, rtol = atol = 1e-4, the tolerance of
  ``test_torch_resnet.py``: XLA-CPU and oneDNN sum the convs in other
  orders), and written back by the port is byte-identical; a port file read
  by the JAX ``load_model`` holds the port's tensors exactly.
* Train state both ways: a JAX ``save_train_state`` after 2 jitted steps
  read by the port's ``load_train_state`` gives Adam's moments, step, lr,
  epoch and ``extra`` exactly; one more step in each package from the same
  gradients agrees within 1e-6 of the parameter scale
  (``test_torch_train.py``'s Adam tolerance: the same update rounded in
  another order); the port's file read by the JAX ``load_train_state``
  holds the port's arrays exactly.
* ``load_torchvision_weights``: the port and the JAX function load the same
  seeded state dict with torchvision's names into the same weights, exactly
  (the JAX side through a stand-in ``torchvision.models``).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_resnet import _random_variables

from deephisto_tpu.models.patch_cls_simple.train import make_steps as jax_make_steps
from deephisto_tpu.models.resnet import ResNet18 as JResNet18
from deephisto_tpu.models.resnet import load_torchvision_weights as jax_load_tv
from deephisto_tpu.models.vit import ViT as JViT
from deephisto_tpu.train import checkpoint as jck
from deephisto_tpu.train import create_train_state as jax_create_train_state
from deephisto_tpu_torch.models import ResNet18, ViT, flax_resnet_to_torch, torch_to_flax
from deephisto_tpu_torch.models.resnet import load_torchvision_weights
from deephisto_tpu_torch.train import _msgpack, checkpoint, create_train_state

VIT = dict(num_classes=5, patch=8, dim=64, depth=1, heads=2)
SIZE = 32
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _models(arch, seed=0):
    """(flax module, random numpy variables, the port's float32 model)."""
    if arch == "vit":
        jm, tm = JViT(dtype=jnp.float32, **VIT), ViT(dtype=torch.float32, img_size=SIZE, **VIT)
    else:
        jm = JResNet18(num_classes=5, num_filters=8, dtype=jnp.float32)
        tm = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    v = _random_variables(shapes, np.random.default_rng(seed))
    v.setdefault("batch_stats", {})
    return jm, v, tm


def _opt_state_dict(v, wd):
    tx = (optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3, weight_decay=wd) if wd
          else optax.inject_hyperparams(optax.adam)(learning_rate=1e-3))
    return jax.device_get(serialization.to_state_dict(tx.init(v["params"])))


def _tree():
    _, r18, _ = _models("resnet")
    _, vit, _ = _models("vit", seed=1)
    return {"r18": r18, "vit": vit, "adam": _opt_state_dict(r18, 0.0),
            "adamw": _opt_state_dict(vit, 0.05), "step": 7, "epoch": 3,
            "extra": {"best_val_acc": 0.625, "lr": 3e-4, "sched_best": None,
                      "sched_bad_epochs": 2, "note": "résumé", "big": 2**40, "neg": -300,
                      "flag": True, "scalar": np.float32(1.5)}}


def _assert_same_tree(got, want, ordered=False):
    """Equal trees: the same keys (in the same order with ``ordered``), leaf
    types, dtypes, shapes and values."""
    assert type(got) is type(want) or (isinstance(got, np.ndarray) and isinstance(want, np.ndarray))
    if isinstance(want, dict):
        assert (list(got) == list(want)) if ordered else (sorted(got) == sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], ordered)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("chunk", [None, 1000])
def test_codec_is_flax_msgpack(monkeypatch, chunk):
    if chunk is not None:  # arrays over 1000 bytes go in the chunked form
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = _tree()
    want = serialization.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == want
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in want
    _assert_same_tree(_msgpack.unpackb(want), serialization.msgpack_restore(want), ordered=True)


def test_codec_refuses_what_flax_refuses():
    for bad in ((1, 2), {"a": (1,)}, {"a": object()}, {"a": 1j}):
        with pytest.raises(ValueError):
            _msgpack.packb(bad)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(_msgpack.packb({"a": np.zeros(4, np.float32)})[:-3])


def test_codec_bfloat16_is_a_torch_tensor():
    t = torch.randn(3, 5).to(torch.bfloat16)
    want = serialization.msgpack_serialize({"x": jnp.asarray(t.float().numpy(), jnp.bfloat16)})
    assert _msgpack.packb({"x": t}) == want
    back = _msgpack.unpackb(want)["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_jax_weights_load_into_the_port_and_write_back_identically(tmp_path, arch):
    jm, v, tm = _models(arch)
    jck.save_model(tmp_path / "jax.msgpack", v["params"], v["batch_stats"])
    checkpoint.load_variables(tm, checkpoint.load_model(tmp_path / "jax.msgpack"))
    x = np.random.default_rng(2).uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    checkpoint.save_model(tmp_path / "port.msgpack", tm)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


@pytest.mark.parametrize("arch", ["resnet", "vit"])
def test_port_weights_load_into_jax_exactly(tmp_path, arch):
    _, v, tm = _models(arch, seed=3)
    tm.load_state_dict(flax_resnet_to_torch(v))
    checkpoint.save_model(tmp_path / "port.msgpack", tm)
    got = jck.load_model(tmp_path / "port.msgpack")
    want = torch_to_flax(tm.state_dict().items())
    _assert_same_tree(jax.tree.map(np.asarray, got), want)
    _assert_same_tree(want, {k: jax.tree.map(np.asarray, v[k]) for k in want})


def _jax_state_after_two_steps(wd):
    jm, v, tm = _models("resnet", seed=5)
    jstate = jax_create_train_state(jm, jax.tree.map(jnp.asarray, v), 1e-3, weight_decay=wd)
    train_step, _ = jax_make_steps(jm)
    rng = np.random.default_rng(6)
    for _ in range(2):
        x = jnp.asarray(rng.uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32))
        jstate, _, _ = train_step(jstate, x, jnp.asarray(rng.integers(0, 5, 4).astype(np.int32)))
    template = jax_create_train_state(jm, jax.tree.map(jnp.asarray, v), 1e-3, weight_decay=wd)
    return jstate, template, tm


def _flax_moment(opt_state, key):
    return flax_resnet_to_torch({"params": jax.tree.map(np.asarray,
                                                        getattr(opt_state.inner_state[0], key))})


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_train_state_crosses_both_ways(tmp_path, wd):
    jstate, template, tm = _jax_state_after_two_steps(wd)
    extra = {"best_val_acc": 0.5, "lr": 1e-3, "sched_best": None, "sched_bad_epochs": 1,
             "sched_epoch": 2}
    jck.save_train_state(tmp_path / "jax.msgpack", jstate, 2, extra=extra)
    state = create_train_state(tm, 0.1, weight_decay=wd)
    state, epoch, got_extra = checkpoint.load_train_state(tmp_path / "jax.msgpack", state)
    assert (epoch, got_extra, state.step) == (2, extra, 2)
    opt = state.optimizer
    assert opt.param_groups[0]["lr"] == float(np.float32(1e-3))
    mu, nu = _flax_moment(jstate.opt_state, "mu"), _flax_moment(jstate.opt_state, "nu")
    params = flax_resnet_to_torch(jax.tree.map(np.asarray, {"params": jstate.params,
                                                            "batch_stats": jstate.batch_stats}))
    for name, p in tm.named_parameters():
        s = opt.state[p]
        assert float(s["step"]) == 2.0 == int(jstate.opt_state.inner_state[0].count)
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
        assert torch.equal(p.detach(), params[name])
    for name, b in tm.named_buffers():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(b, params[name])

    # one more step in each package from the same gradients
    rng = np.random.default_rng(8)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         jax.tree.map(np.asarray, jstate.params))
    jstate = jstate.apply_gradients(grads=jax.tree.map(jnp.asarray, grads))
    tgrads = flax_resnet_to_torch({"params": grads})
    for name, p in tm.named_parameters():
        p.grad = tgrads[name].contiguous(memory_format=torch.preserve_format)
    opt.step()
    state.step += 1
    want = flax_resnet_to_torch(jax.tree.map(np.asarray, {"params": jstate.params}))
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0, atol=1e-6 * scale)

    # the port's file, read by the JAX package
    checkpoint.save_train_state(tmp_path / "port.msgpack", state, 3, extra=extra)
    back, epoch, got_extra = jck.load_train_state(tmp_path / "port.msgpack", template)
    assert (epoch, got_extra, int(back.step)) == (3, extra, 3)
    got = flax_resnet_to_torch(jax.tree.map(np.asarray, {"params": back.params,
                                                         "batch_stats": back.batch_stats}))
    mu, nu = _flax_moment(back.opt_state, "mu"), _flax_moment(back.opt_state, "nu")
    assert int(back.opt_state.count) == int(back.opt_state.inner_state[0].count) == 3
    assert float(back.opt_state.hyperparams["learning_rate"]) == float(np.float32(1e-3))
    for name, p in tm.named_parameters():
        assert torch.equal(got[name], p.detach())
        assert torch.equal(mu[name], opt.state[p]["exp_avg"])
        assert torch.equal(nu[name], opt.state[p]["exp_avg_sq"])


def test_train_state_refuses_another_optimizer(tmp_path):
    _, v, tm = _models("resnet")
    tm.load_state_dict(flax_resnet_to_torch(v))
    checkpoint.save_train_state(tmp_path / "adam.msgpack", create_train_state(tm, 1e-3), 1)
    with pytest.raises(ValueError, match="optimizer"):
        checkpoint.load_train_state(tmp_path / "adam.msgpack",
                                    create_train_state(tm, 1e-3, weight_decay=0.05))
    sgd = create_train_state(tm, 1e-3, tx=torch.optim.SGD(tm.parameters(), lr=1e-3))
    with pytest.raises(ValueError, match="Adam"):
        checkpoint.save_train_state(tmp_path / "sgd.msgpack", sgd, 1)


def _torchvision_state_dict(seed=0):
    """A seeded ResNet-18 state dict under torchvision's names."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in ResNet18(num_classes=1000).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        k = k.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.", "downsample.1.")
        if k.startswith("layer"):
            stage, rest = k.split("_", 1)
            k = f"{stage}.{rest}"
        sd[k] = torch.randn(t.shape, generator=gen) * 0.1 + (1.0 if k.endswith("var") else 0.0)
    return sd


def test_torchvision_weights_match_jax(tmp_path, monkeypatch):
    sd = _torchvision_state_dict()
    path = tmp_path / "resnet18-0000.pth"
    torch.save(sd, path)
    tm = ResNet18(num_classes=5, dtype=torch.float32)
    fc = tm.fc.weight.detach().clone()
    assert load_torchvision_weights(tm, 18, path) is tm
    assert torch.equal(tm.fc.weight, fc) and torch.equal(tm.layer2_0.downsample_bn.running_var,
                                                         sd["layer2.0.downsample.1.running_var"])

    class _TV:  # torchvision.models, as the JAX function calls it
        def __init__(self, state):
            self._state = state

        def state_dict(self):
            return self._state

    weights = types.SimpleNamespace(DEFAULT=None)
    fake = types.ModuleType("torchvision.models")
    for d in (18, 34, 50, 101):
        setattr(fake, f"resnet{d}", lambda weights=None: _TV(sd))
        setattr(fake, f"ResNet{d}_Weights", weights)
    pkg = types.ModuleType("torchvision")
    pkg.models = fake
    monkeypatch.setitem(sys.modules, "torchvision", pkg)
    monkeypatch.setitem(sys.modules, "torchvision.models", fake)
    jm = JResNet18(num_classes=5)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    v = _random_variables(shapes, np.random.default_rng(0))
    got = jax_load_tv(v, depth=18)
    assert got is not None
    want = torch_to_flax(tm.state_dict().items())
    for col in ("params", "batch_stats"):
        jtree = jax.tree.map(np.asarray, got[col])
        jtree.pop("fc", None)
        want[col].pop("fc", None)
        _assert_same_tree(jtree, want[col])

    monkeypatch.setattr(torch.hub, "get_dir", lambda: str(tmp_path / "empty_hub"))
    assert load_torchvision_weights(ResNet18(num_classes=5), 18) is None
    assert load_torchvision_weights(ResNet18(num_classes=5), 18, tmp_path / "missing.pth") is None
