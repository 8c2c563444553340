"""The port's training program and its host-side helpers against the JAX
package's, on the CPU, at small size.

* Resume: ``train(cfg, device="cpu")`` for 3 epochs, and for 2 epochs then
  ``resume`` for 1, write the same ``last_state.msgpack`` byte for byte
  (weights, BatchNorm statistics, Adam's moments and steps, counters,
  scheduler state) and the same ``metrics.csv`` rows but for the
  ``patches_per_s`` column, a timing. Exact: the epoch's random streams are
  a function of (seed, epoch) and the checkpoint holds the state exactly.
* ``load_config`` equals ``yaml.safe_load`` on every YAML config of the
  repo and on the YAML 1.1 typing cases (``1e-5`` is a string, ``1.0e-5`` a
  float, quoted strings, flow lists), and raises outside its subset.
* The PNG reader reads PNGs of every row filter (PIL's own files, and a
  file with all five filters) as PIL reads them. The
  extracted test set is JPEG, read pixel-equal by both packages'
  ``load_image_folder``, and its files are byte for byte the ones the JAX
  package's ``extract_and_save_subset`` writes from the same patches.
* ``ContextWindowModel``: logits and train-mode BatchNorm updates of a
  float32 ResNet-18 (8 filters) at patch 64 and context 32 within rtol =
  atol = 1e-4 of the JAX wrapper's (``test_torch_resnet.py``'s float32
  tolerance: the convs sum in other orders).
* ``preprocess_batch``: equal to the JAX function without flips, and each
  flip equal to JAX's flip of the same batch when a generator draws it. The
  JAX oracle runs op by op (``jax.disable_jit()``): jitted, XLA-CPU
  rewrites ``/ 255`` as ``* (1/255)``, which rounds differently in half the
  elements (by one ulp).
* ``predict``: the JAX class on the same checkpoint and PNG, bare and with
  ``model.context``.

oneDNN is switched off for the tests that train (``test_torch_train.py``
says why).
"""

import io
import shutil
import struct
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_resnet import _random_variables

from deephisto_tpu.models.patch_cls_simple import predict as jax_predict
from deephisto_tpu.models.patch_cls_simple import utils as jax_utils
from deephisto_tpu.models.patch_cls_simple.context import ContextWindowModel as JContext
from deephisto_tpu.models.patch_cls_simple.model import get_model as jax_get_model
from deephisto_tpu.models.resnet import ResNet18 as JResNet18
from deephisto_tpu.ops.augment import preprocess_batch as jax_preprocess
from deephisto_tpu.train import checkpoint as jck
from deephisto_tpu_torch import _imageio
from deephisto_tpu_torch.data import ensure_synthetic_dataset
from deephisto_tpu_torch.models import ResNet18, flax_resnet_to_torch
from deephisto_tpu_torch.models.patch_cls_simple import ContextWindowModel
from deephisto_tpu_torch.models.patch_cls_simple import predict as port_predict
from deephisto_tpu_torch.models.patch_cls_simple import train as port_train
from deephisto_tpu_torch.models.patch_cls_simple.utils import (
    load_config,
    load_image_folder,
    parse_yaml,
)
from deephisto_tpu_torch.ops import preprocess_batch, preprocess_batch_per_sample
from deephisto_tpu_torch.utils import get_img_ano_paths

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def train_cfg(tmp_path_factory):
    """A 512² dataset (as tests/test_train.py makes it) with its test set
    extracted, and a ResNet-18 config at patch 32. The synthetic marker is
    removed, so that ``resolve_dataset`` takes the folder as it is and does
    not remake it at the default size."""
    root = tmp_path_factory.mktemp("train_cli")
    ds = ensure_synthetic_dataset(root / "ds", n_train=1, n_test=1, height=512, width=512,
                                  seed=9, max_layer=4)
    (ds / ".synthetic_complete.json").unlink()
    cfg = {
        "model": {"n_classes": 5, "depth": 18},
        "training": {"batch_size": 8, "n_epochs": 3, "lr": 0.001, "augment_factor": 1,
                     "save_dir": str(root / "ck"), "out_dir": str(root / "out"),
                     "val_steps": 2, "one_image_for_batch": False, "train_steps": 2},
        "test": {"dir": str(root / "test"), "samples_per_class": 4},
        "dataset": {"folder": str(ds), "layer": 2, "patch_size": 32,
                    "patches_from_one_region": 4},
    }
    port_train.prepare_test_patches(cfg, device="cpu")
    return root, cfg


def _run(cfg, root, tag, n_epochs, resume=False):
    cfg = {**cfg, "training": {**cfg["training"], "n_epochs": n_epochs,
                               "save_dir": str(root / f"ck_{tag}"),
                               "out_dir": str(root / f"out_{tag}")}}
    return port_train.train(cfg, resume=resume, device="cpu"), cfg


def test_resume_is_the_uninterrupted_run(train_cfg):
    root, cfg = train_cfg
    whole, cfg_a = _run(cfg, root, "whole", 3)
    _run(cfg, root, "split", 2)
    resumed, cfg_b = _run(cfg, root, "split", 3, resume=True)
    assert len(whole["train_losses"]) == 3 and len(resumed["train_losses"]) == 1
    assert resumed["train_losses"] == whole["train_losses"][-1:]
    a, b = (Path(c["training"]["save_dir"]) / "last_state.msgpack" for c in (cfg_a, cfg_b))
    assert a.read_bytes() == b.read_bytes()

    def rows(c):
        lines = (Path(c["training"]["out_dir"]) / "metrics.csv").read_text().splitlines()
        return [r.rsplit(",", 1)[0] for r in lines]  # all but patches_per_s

    assert rows(cfg_a) == rows(cfg_b) and len(rows(cfg_a)) == 4
    assert rows(cfg_a)[0] == port_train.METRICS_HEADER.rsplit(",", 1)[0]
    best = Path(cfg_a["training"]["out_dir"]) / "best_model.msgpack"
    assert best.is_file() and (Path(cfg_a["training"]["out_dir"]) / "loss.jpg").is_file()


def test_test_set_is_png_read_alike_by_both_packages(train_cfg):
    root, cfg = train_cfg
    test_dir = Path(cfg["test"]["dir"])
    files = sorted(test_dir.glob("*/*.jpg"))
    assert files and not list(test_dir.glob("*/*.png"))
    got = load_image_folder(test_dir)
    want = jax_utils.load_image_folder(test_dir)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for f in files[:4]:
        np.testing.assert_array_equal(got[0][files.index(f)], np.asarray(Image.open(f)))


def test_test_set_is_the_jax_packages_files(train_cfg, tmp_path, monkeypatch):
    """The port's ``extract_and_save_subset`` writes, byte for byte, the
    files that the JAX package's writes when its sampler draws the same
    patches (a stand-in replays the port's draws, infeasible classes
    included)."""
    import deephisto_tpu.samplers.region as jax_region
    from deephisto_tpu_torch.samplers import region as port_region

    root, cfg = train_cfg
    pairs = get_img_ano_paths(cfg["dataset"]["folder"], "test")
    drawn, refused = {}, {}
    port_sampler = port_region.AnnoRegionRndSampler
    orig_gen, orig_check = port_sampler.structs_generator, port_sampler._check_forced_cls

    def spy_gen(self, *a, cls_idx, **k):
        for batch in orig_gen(self, *a, cls_idx=cls_idx, **k):
            drawn.setdefault(cls_idx, []).append(batch)
            yield batch

    def spy_check(self, cls_idx):
        try:
            return orig_check(self, cls_idx)
        except ValueError as e:
            refused[cls_idx] = e
            raise

    monkeypatch.setattr(port_sampler, "structs_generator", spy_gen)
    monkeypatch.setattr(port_sampler, "_check_forced_cls", spy_check)
    port_region.extract_and_save_subset(pairs, tmp_path / "port", 48, 2, 5, device="cpu")
    classes = port_sampler(pairs, layer=2, patch_size=48, device="cpu", verbose=False).classes

    class Replay:
        def __init__(self, **kwargs):
            self.classes = classes

        def _check_forced_cls(self, cls_idx):
            if cls_idx in refused:
                raise refused[cls_idx]

        def structs_generator(self, batch_size, n_batches, cls_idx):
            yield from drawn[cls_idx]

    monkeypatch.setattr(jax_region, "AnnoRegionRndSampler", Replay)
    jax_region.extract_and_save_subset(pairs, tmp_path / "jax", 48, 2, 5)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    assert any(p.suffix == ".jpg" for p in files) and refused
    for p in files:
        if p.suffix:
            assert (tmp_path / "port" / p).read_bytes() == (tmp_path / "jax" / p).read_bytes(), p


def test_plots_and_jpeg_need_their_libraries(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert port_train.save_plot([1.0], [1.0], [], "Loss", "loss.jpg", tmp_path) is False
    assert not (tmp_path / "loss.jpg").exists()
    (tmp_path / "0").mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "0" / "a.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="a.jpg.*PIL"):
        load_image_folder(tmp_path)


YAML_FILES = [
    "models/patch_cls_simple/config.yaml",
    "benchmarks/config_ctx64.yaml",
    *(f"deephisto_tpu/models/patch_cls_simple/{n}" for n in
      ("config.yaml", "config_vit.yaml", "config_resnet50_multimag.yaml")),
    *(f"deephisto_tpu_torch/models/patch_cls_simple/{n}" for n in
      ("config.yaml", "config_vit.yaml", "config_resnet50_multimag.yaml")),
]


@pytest.mark.parametrize("name", YAML_FILES)
def test_load_config_is_yaml_safe_load(name):
    path = REPO / name
    assert load_config(path) == yaml.safe_load(path.read_text())


def test_yaml_typing_and_refusals():
    text = """
a: 1e-5
b: 1.0e-5
c: 0.0001
d: 'it''s # kept'
e: "tab\\there"   # a comment
f: [1, 2.5, 'q', yes, ~, [3, 4], 0x1F, 010, 1_000, -.inf]
g: True
h: off
i:
"k k": v
l:
  m:
    n: 12
  o: plain text
"""
    got = parse_yaml(text)
    assert got == yaml.safe_load(text)
    assert got["a"] == "1e-5" and got["b"] == 1e-5 and got["h"] is False
    for bad in ("a: &x 1\nb: *x\n", "- 1\n", "a: |\n  x\n", "a: {b: 1}\n", "---\na: 1\n",
                "a: 2001-12-14\n", "a: !!str 1\n", "a:\n\tb: 1\n", "a: 1\n  b: 2\n"):
        with pytest.raises(ValueError):
            parse_yaml(bad)


def _png_with_filters(img: np.ndarray) -> bytes:
    """``img`` as a PNG whose row y carries filter y % 5 (None, Sub, Up,
    Average, Paeth), encoded as the PNG spec defines them."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        kind, cur = y % 5, a[y]
        prev = a[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, 2, 0, 0, 0])

    def chunk(kind: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(kind + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)

    return (_imageio.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_codec(tmp_path):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:40, 0:36]
    smooth = np.stack([(x * 5) % 256, (y * 3) % 256, (x + y) % 256], -1).astype(np.uint8)
    noisy = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    for img in (smooth, noisy, (smooth + rng.integers(0, 8, smooth.shape)).astype(np.uint8)):
        Image.fromarray(img).save(tmp_path / "pil.png")
        np.testing.assert_array_equal(_imageio.read_png(tmp_path / "pil.png"), img)
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="PNG")  # PIL picks its filters per row
        np.testing.assert_array_equal(_imageio.decode_png(b.getvalue()), img)
        crafted = _png_with_filters(img)
        np.testing.assert_array_equal(_imageio.decode_png(crafted), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(crafted))), img)
    for mode, conv in (("L", lambda a: a[..., :1].repeat(3, -1)), ("RGBA", lambda a: a[..., :3])):
        src = np.concatenate([noisy, noisy[..., :1]], -1) if mode == "RGBA" else noisy[..., 0]
        b = io.BytesIO()
        Image.fromarray(src, mode).save(b, format="PNG")
        want = np.asarray(Image.open(io.BytesIO(b.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(_imageio.decode_png(b.getvalue()), want)
    with pytest.raises(ValueError):
        _imageio.decode_png(b"not a png")


def test_context_window_model_matches_jax():
    jm = JResNet18(num_classes=5, num_filters=8, dtype=jnp.float32)
    win = 64 + 2 * 32
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, win, win, 3)))
    v = _random_variables(shapes, np.random.default_rng(1))
    tm = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32)
    tm.load_state_dict(flax_resnet_to_torch(v))
    jw, tw = JContext(jm, patch_size=64, context=32), ContextWindowModel(tm, 64, 32)
    x = np.random.default_rng(2).uniform(size=(4, win, win, 3)).astype(np.float32)
    want = np.asarray(jw.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(tw.eval()(torch.from_numpy(x)).detach().numpy(), want, **TOL)
    want, upd = jw.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tw.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = flax_resnet_to_torch({"params": {}, "batch_stats": jax.tree.map(np.asarray,
                                                                             upd["batch_stats"])})
    buffers = dict(tw.named_buffers())
    for name, s in stats.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(buffers[f"inner.{name}"].numpy(), s.numpy(), **TOL)
    assert [n for n, _ in tw.named_parameters()] == [f"inner.{n}" for n, _ in tm.named_parameters()]
    with pytest.raises(ValueError):
        ContextWindowModel(tm, 64, 16)


def test_preprocess_matches_jax():
    u8 = np.random.default_rng(3).integers(0, 256, (4, 6, 5, 3), dtype=np.uint8)
    with jax.disable_jit():  # jitted, XLA-CPU turns / 255 into * (1/255)
        base = np.asarray(jax_preprocess(jnp.asarray(u8)))
    t = torch.from_numpy(u8)
    np.testing.assert_array_equal(preprocess_batch(t).numpy(), base)
    flips = {
        (False, False): base, (True, False): base[:, :, ::-1], (False, True): base[:, ::-1],
        (True, True): base[:, ::-1, ::-1],
    }
    seen = set()
    for seed in range(16):
        gen = torch.Generator().manual_seed(seed)
        h, v = (torch.rand((), generator=gen) < 0.5).item(), (torch.rand((), generator=gen) < 0.5).item()
        got = preprocess_batch(t, torch.Generator().manual_seed(seed), augment=True).numpy()
        np.testing.assert_array_equal(got, flips[(h, v)])
        seen.add((h, v))
    assert seen == set(flips)
    per = preprocess_batch_per_sample(t, torch.Generator().manual_seed(0)).numpy()
    for i in range(4):
        assert any(np.array_equal(per[i], f[i]) for f in flips.values())
    with pytest.raises(ValueError):
        preprocess_batch(t, augment=True)


@pytest.mark.parametrize("context", [0, 32])
def test_predict_matches_jax(tmp_path, context):
    cfg = {"model": {"n_classes": 5, "depth": 18, "context": context},
           "dataset": {"patch_size": 32}}
    jm = jax_get_model(5, depth=18)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    v = _random_variables(shapes, np.random.default_rng(4))
    jck.save_model(tmp_path / "best.msgpack", v["params"], v["batch_stats"])
    classes = set()
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / "p.png")
        want = jax_predict.predict(tmp_path / "p.png", tmp_path / "best.msgpack", cfg)
        got = port_predict.predict(tmp_path / "p.png", tmp_path / "best.msgpack", cfg, device="cpu")
        assert got == want
        classes.add(got)
    shutil.copy(tmp_path / "p.png", tmp_path / "q.png")
    np.testing.assert_array_equal(port_predict.load_image(tmp_path / "q.png", 32), img)
