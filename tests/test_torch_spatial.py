"""The port's parallel predicts and training steps on the CPU, on gloo
process groups, against the JAX package's on its virtual 8-device mesh and
against the port's own single-process paths.

Inputs are seeded numpy arrays; the weights are random flax variables
converted by ``models/convert.py`` (the tiny conv model of
``tests/test_multichip.py`` by hand: two kernels transposed).

* One rank, in this process: ``predict_full_fused(mesh=)``,
  ``predict_full_spatial`` and ``predict_full_fcn_spatial`` (float and int8
  pack_l1) equal the single predicts bit for bit (maps and scores).
* 2 and 4 ranks (``test_torch_parallel.run_ranks``, one spawn a world
  size), the f32 tiny model:
  - the DP predict against the JAX one with the same mesh size (argmax equal;
    scores within 1e-5 of their largest magnitude: the two frameworks' f32
    convs sum in other orders) and against the port's single predict
    (argmax equal; scores within 1e-5 of their largest magnitude: a cell's
    patches are summed in another order across ranks);
  - ``predict_full_spatial`` against the JAX one and the port's single
    predict (argmax equal; it returns no scores).
  The JAX predicts are compiled with ``xla_allow_excess_precision`` off, as
  in ``tests/test_torch_pipeline.py``, so they keep ``model_input``'s bf16
  rounding.
* ``predict_full_fcn_spatial`` at 2 and 4 ranks with a narrow s2d ResNet-18
  (float, and int8 pack_l1 quantized by the port), against the port's
  ``predict_full_fcn``: argmax bit-equal, scores within 1e-5 absolute (the
  JAX package's ``test_fcn_spatial_matches_single_chip`` bound); the float
  model also against the JAX ``predict_full_fcn_spatial``: argmax equal,
  and the scores' difference at most 1e-5 above the two frameworks'
  difference on the single fcn (their f32 convs sum in other orders; 5e-5
  here, within test_torch_resnet.py's 1e-4 on logits).
* Training, float32:
  - 3 data-parallel steps of a narrow ResNet-18 (imagenet stem, 64², Adam
    1e-3, a global batch of 16) at 2 ranks against JAX's ``make_steps(model,
    mesh)`` on 2 devices and against the port's single steps: losses within
    rtol 2e-4 (``tests/test_multichip.py``'s bound); BatchNorm's running
    statistics equal on the ranks and within 1e-4 of the single ones;
  - ``make_fused_epoch(mesh=)`` at 2 ranks (3 steps, crop 4 and flips, SGD)
    against the single epoch: losses rtol 2e-4, correct counts equal;
  - tensor parallelism of a narrow ViT (linear and BN conv stems; at 4 ranks
    the linear stem on a 2×2 data × model mesh) against the single steps:
    losses rtol 1e-5 (``tests/test_tensor_parallel.py``'s bound), the MLP
    weights and their Adam moments sharded, the gathered state's shapes the
    model's;
  - the GPipe pipeline (2 stages, GroupNorm conv stem; at 4 ranks 2 data
    shards of 2 stages, linear stem) against the single steps: losses rtol
    1e-5 and correct counts equal (``tests/test_pipeline.py``'s bound); its
    eval logits and the canonical parameters' forward within 1e-5.
* The refusals of ``parallel/tensor.py`` and ``parallel/pipeline.py``.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_parallel import run_ranks, world1  # noqa: F401 (a fixture)
from torch import nn

from deephisto_tpu_torch.models.vit import _SameConvBias

SCORE_REL = 1e-5
FCN_ATOL = 1e-5
LOSS_RTOL_DP = 2e-4
LOSS_RTOL = 1e-5
ADAM_RTOL = 2e-3
PS, D, BS = 32, 16, 16
FCN_KW = dict(n_classes=5, patch_size=64, downscale=16, tile=32, halo=32, tile_batch=2)
VIT_KW = dict(num_classes=5, patch=8, dim=64, heads=4, img_size=16)


class Tiny(nn.Module):
    """tests/test_multichip.py's ``Tiny`` (a 3×3/2 SAME conv with bias, ReLU,
    the spatial mean, a Dense to 5 classes) on NHWC input."""

    def __init__(self):
        super().__init__()
        self.conv = _SameConvBias(3, 8, 3, 2)
        self.dense = nn.Linear(8, 5)

    def forward(self, x):
        y = F.relu(self.conv(x.float().permute(0, 3, 1, 2)))
        return self.dense(y.mean(dim=(2, 3)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- inputs (this process, with JAX) ---------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded slides, flax variables and their port state dicts, saved for
    the ranks; the JAX modules kept here for the oracles."""
    import jax
    import jax.numpy as jnp
    import flax.linen as fnn
    from test_torch_resnet import _random_variables, flax_and_torch_resnet

    from deephisto_tpu.models.vit import ViT as JViT
    from deephisto_tpu_torch.models import ViT, flax_vit_to_torch

    class JTiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            x = fnn.Conv(8, (3, 3), (2, 2))(x)
            x = fnn.relu(x)
            x = jnp.mean(x, axis=(1, 2))
            return fnn.Dense(5)(x)

    jtiny = JTiny()
    tv = jax.tree.map(np.asarray, jtiny.init(jax.random.key(0), jnp.zeros((1, PS, PS, 3))))
    tv = {"params": tv["params"], "batch_stats": {}}
    p = tv["params"]
    tiny = {"conv.weight": torch.from_numpy(p["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
            "conv.bias": torch.from_numpy(p["Conv_0"]["bias"].copy()),
            "dense.weight": torch.from_numpy(p["Dense_0"]["kernel"].T.copy()),
            "dense.bias": torch.from_numpy(p["Dense_0"]["bias"].copy())}

    jfcn, vfcn, tfcn = flax_and_torch_resnet(18, stem="s2d", num_filters=8, size=64)
    jtrain, vtrain, ttrain = flax_and_torch_resnet(18, stem="imagenet", num_filters=8, size=64)
    vits = {}
    for stem, depth in (("linear", 2), ("conv", 2), ("conv_gn", 4), ("linear4", 4)):
        s = stem.rstrip("4")
        jm = JViT(dtype=jnp.float32, stem=s, depth=depth, **{k: v for k, v in VIT_KW.items()
                                                            if k != "img_size"})
        shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
        tm = ViT(dtype=torch.float32, stem=s, depth=depth, **VIT_KW)
        tm.load_state_dict(flax_vit_to_torch(_random_variables(shapes, np.random.default_rng(2))))
        vits[stem] = tm.state_dict()

    rng = np.random.default_rng(0)
    data = {
        "tiny": tiny,
        "img_dp": np.random.default_rng(0).integers(0, 255, (256, 256, 3), dtype=np.uint8),
        "img_sp": np.random.default_rng(1).integers(0, 255, (512, 256, 3), dtype=np.uint8),
        "img_fcn": np.random.default_rng(3).integers(0, 255, (160, 130, 3), dtype=np.uint8),
        "calib": np.random.default_rng(5).random((4, 64, 64, 3)).astype(np.float32),
        "fcn": tfcn.state_dict(),
        "train": ttrain.state_dict(),
        "train_batches": [(rng.normal(size=(16, 64, 64, 3)).astype(np.float32),
                           rng.integers(0, 5, size=(16,)).astype(np.int64)) for _ in range(3)],
        "epoch_batch": (rng.integers(0, 256, (8, 72, 72, 3), dtype=np.uint8),
                        rng.integers(0, 5, size=(8,)).astype(np.int64)),
        "vit": vits,
        "vit_batches": [(rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
                         rng.integers(0, 5, size=(16,)).astype(np.int64)) for _ in range(3)],
    }
    data["train_cfg"] = _train_cfg(tmp_path_factory.mktemp("train_program"))
    path = tmp_path_factory.mktemp("inputs") / "inputs.pt"
    torch.save(data, path)
    return {"path": str(path), "data": data, "jtiny": jtiny, "tv": tv, "jfcn": jfcn,
            "vfcn": vfcn, "jtrain": jtrain, "vtrain": vtrain}


def _train_cfg(root):
    """tests/test_torch_train_cli.py's training program: a 512² dataset,
    its test set extracted, a ResNet-18 at patch 64 (its last stage
    normalises 2×2 positions of 8 patches: at patch 32, 8 numbers a channel,
    and Adam turns the variance formulas' rounding into 1 % of the loss),
    batch 8, 2 epochs of 1 step."""
    from deephisto_tpu_torch.data import ensure_synthetic_dataset
    from deephisto_tpu_torch.models.patch_cls_simple import train as port_train

    ds = ensure_synthetic_dataset(root / "ds", n_train=1, n_test=1, height=512, width=512,
                                  seed=9, max_layer=4)
    (ds / ".synthetic_complete.json").unlink()
    cfg = {
        "model": {"n_classes": 5, "depth": 18},
        "training": {"batch_size": 8, "n_epochs": 2, "lr": 0.001, "augment_factor": 1,
                     "save_dir": str(root / "ck"), "out_dir": str(root / "out"),
                     "val_steps": 2, "one_image_for_batch": False, "train_steps": 1},
        "test": {"dir": str(root / "test"), "samples_per_class": 4},
        "dataset": {"folder": str(ds), "layer": 2, "patch_size": 64,
                    "patches_from_one_region": 4},
    }
    with torch.backends.mkldnn.flags(enabled=False):
        port_train.prepare_test_patches(cfg, device="cpu")
    return cfg


def _strict(monkeypatch):
    """Compile the JAX package's jitted predicts with
    ``xla_allow_excess_precision`` off (module docstring)."""
    import jax

    from deephisto_tpu.predict import pipeline as jax_pipeline

    opts = {"xla_allow_excess_precision": False}
    scan = jax_pipeline._predict_scan
    monkeypatch.setattr(jax_pipeline, "_predict_scan", jax.jit(
        scan.__wrapped__, static_argnames=("model", "patch_size", "downscale", "n_classes",
                                           "softmax", "mesh", "packed", "hw"),
        compiler_options=opts))
    monkeypatch.setattr(jax, "jit", functools.partial(jax.jit, compiler_options=opts))


_JAX = {}


@pytest.fixture
def jax_predicts(inputs, monkeypatch):
    """world -> the JAX package's DP predict (argmax, scores), spatial map
    and float fcn spatial (argmax, scores) on ``world`` virtual devices."""
    import jax

    from deephisto_tpu.parallel import make_mesh as jax_make_mesh
    from deephisto_tpu.parallel import predict_full_fcn_spatial as jax_fcn_spatial
    from deephisto_tpu.parallel import predict_full_spatial as jax_spatial
    from deephisto_tpu.predict import predict_full_fused as jax_fused
    from deephisto_tpu.predict.fcn import predict_full_fcn as jax_fcn

    def get(world):
        if world not in _JAX:
            with monkeypatch.context() as m:
                _strict(m)
                mesh = jax_make_mesh(jax.devices()[:world])
                d = inputs["data"]
                kw = dict(n_classes=5, patch_size=PS, stride=PS, batch_size=BS, downscale=D)
                dp = jax_fused(d["img_dp"], inputs["jtiny"], inputs["tv"], mesh=mesh, **kw)
                sp = jax_spatial(d["img_sp"], inputs["jtiny"], inputs["tv"], mesh=mesh, **kw)
                fcn = jax_fcn_spatial(d["img_fcn"], inputs["jfcn"], inputs["vfcn"], mesh=mesh,
                                      **FCN_KW)
                if "fcn_single" not in _JAX:
                    _JAX["fcn_single"] = tuple(map(np.asarray, jax_fcn(
                        d["img_fcn"], inputs["jfcn"], inputs["vfcn"], **FCN_KW)))
            _JAX[world] = {"dp": tuple(map(np.asarray, dp)), "sp": np.asarray(sp),
                           "fcn": tuple(map(np.asarray, fcn)), "fcn_single": _JAX["fcn_single"]}
        return _JAX[world]

    return get


# ---- the ranks' work (no JAX) ----------------------------------------------


def _models(d):
    from deephisto_tpu_torch.models import ResNet18
    from deephisto_tpu_torch.models.quantize import quantize_resnet

    tiny = Tiny()
    tiny.load_state_dict(d["tiny"])
    fcn = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32, stem="s2d")
    fcn.load_state_dict(d["fcn"])
    q = quantize_resnet(fcn.eval(), [d["calib"]], pack_l1=True)
    return tiny.eval(), fcn.eval(), q


def _predicts(d, mesh):
    """Each predict with ``mesh`` and without."""
    from deephisto_tpu_torch.parallel import predict_full_fcn_spatial, predict_full_spatial
    from deephisto_tpu_torch.predict import predict_full_fcn, predict_full_fused

    tiny, fcn, q = _models(d)
    kw = dict(n_classes=5, patch_size=PS, stride=PS, batch_size=BS, downscale=D, device="cpu")
    fkw = dict(FCN_KW, device="cpu")
    return {
        "dp": predict_full_fused(d["img_dp"], tiny, mesh=mesh, **kw),
        "dp_single": predict_full_fused(d["img_dp"], tiny, **kw),
        "sp": predict_full_spatial(d["img_sp"], tiny, mesh=mesh, **kw),
        "sp_single": predict_full_fused(d["img_sp"], tiny, **kw),
        "fcn": predict_full_fcn_spatial(d["img_fcn"], fcn, mesh=mesh, **fkw),
        "fcn_single": predict_full_fcn(d["img_fcn"], fcn, **fkw),
        "fcn_int8": predict_full_fcn_spatial(d["img_fcn"], q, mesh=mesh, **fkw),
        "fcn_int8_single": predict_full_fcn(d["img_fcn"], q, **fkw),
    }


def _trajectory(step, state, batches):
    out = []
    for x, y in batches:
        state, loss, correct = step(state, torch.from_numpy(x), torch.from_numpy(y))
        out.append((float(loss), int(correct)))
    return out


def _resnet_dp(d, mesh):
    from deephisto_tpu_torch.models import ResNet18
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.train import create_train_state

    def fresh():
        m = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32, stem="imagenet")
        m.load_state_dict(d["train"])
        return m

    single, dp = fresh(), fresh()
    s = _trajectory(make_steps(single)[0], create_train_state(single, 1e-3), d["train_batches"])
    p = _trajectory(make_steps(dp, mesh)[0], create_train_state(dp, 1e-3), d["train_batches"])
    stats = lambda m: (m.bn1.running_mean.clone(), m.bn1.running_var.clone())  # noqa: E731
    return {"single": s, "dp": p, "stats": stats(dp), "stats_single": stats(single)}


def _fused_epoch_dp(d, mesh):
    from deephisto_tpu_torch.models import ResNet18
    from deephisto_tpu_torch.models.patch_cls_simple import make_fused_epoch
    from deephisto_tpu_torch.train import create_train_state

    u8, labels = (torch.from_numpy(a) for a in d["epoch_batch"])

    def source(gen):
        return u8, labels, None, None

    out = {}
    for name, m in (("single", None), ("dp", mesh)):
        model = ResNet18(num_classes=5, num_filters=8, dtype=torch.float32, stem="imagenet")
        model.load_state_dict(d["train"])
        state = create_train_state(model, 0.0, tx=torch.optim.SGD(model.parameters(), lr=0.05))
        epoch = make_fused_epoch(model, source, 8, 3, mesh=m, crop_pad=4)
        _, losses, corrects = epoch(state, torch.Generator().manual_seed(3))
        out[name] = (losses, corrects)
    return out


def _vit(d, stem):
    from deephisto_tpu_torch.models import ViT

    depth = {"linear": 2, "conv": 2, "conv_gn": 4, "linear4": 4}[stem]
    m = ViT(dtype=torch.float32, stem=stem.rstrip("4"), depth=depth, **VIT_KW)
    m.load_state_dict(d["vit"][stem])
    return m


def _tp(d, stem, data):
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.parallel import make_mesh, place_vit_tensor_parallel
    from deephisto_tpu_torch.parallel.tensor import vit_tp_state_dict
    from deephisto_tpu_torch.train import create_train_state

    mesh = make_mesh(data=data, model=2)
    single, tp = _vit(d, stem), _vit(d, stem)
    s = _trajectory(make_steps(single)[0], create_train_state(single, 1e-3), d["vit_batches"])
    state = place_vit_tensor_parallel(create_train_state(tp, 1e-3), mesh)
    p = _trajectory(make_steps(tp, mesh)[0], state, d["vit_batches"])
    fc1 = tp.block0.fc1.weight
    canon = vit_tp_state_dict(tp, mesh)
    return {"single": s, "tp": p, "fc1": tuple(fc1.shape),
            "mu_fc1": tuple(state.optimizer.state[fc1]["exp_avg"].shape),
            "canon": {k: tuple(v.shape) for k, v in canon.items()},
            "model": {k: tuple(v.shape) for k, v in single.state_dict().items()},
            "fc_rel": max(_rel(canon[k], single.state_dict()[k]) for k in canon if ".fc" in k)}


def _pp(d, stem, stages):
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps
    from deephisto_tpu_torch.parallel import (
        create_pipeline_state,
        make_pipeline_steps,
        make_pp_mesh,
        pipeline_params_to_canonical,
    )
    from deephisto_tpu_torch.train import create_train_state

    mesh = make_pp_mesh(stages=stages)
    single, base = _vit(d, stem), _vit(d, stem)
    s = _trajectory(make_steps(single)[0], create_train_state(single, 1e-3), d["vit_batches"])
    state = create_pipeline_state(base, mesh, 1e-3)
    train_step, eval_step = make_pipeline_steps(base, mesh, n_microbatches=4)
    p = _trajectory(train_step, state, d["vit_batches"])
    x = torch.from_numpy(d["vit_batches"][-1][0])
    _, _, logits = eval_step(state, x, torch.zeros(16, dtype=torch.int64))
    canon = _vit(d, stem)
    canon.load_state_dict(pipeline_params_to_canonical(state, mesh))
    with torch.no_grad():
        ref = canon.eval()(x)
    return {"single": s, "pp": p, "eval_vs_canonical": float((logits - ref).abs().max()),
            "n_blocks": len(state.model.blocks)}


def _train_program(cfg, rank):
    """``train(cfg)`` as torchrun runs it (``WORLD_SIZE`` set, no mesh
    given: the trainer makes it), and on rank 0 the single-process run."""
    import os
    from pathlib import Path

    from deephisto_tpu_torch.models.patch_cls_simple import train as port_train

    def run(tag):
        c = {**cfg, "training": {**cfg["training"], "save_dir": f"{cfg['training']['save_dir']}_{tag}",
                                 "out_dir": f"{cfg['training']['out_dir']}_{tag}"}}
        res = port_train.train(c, device="cpu")
        out = Path(c["training"]["out_dir"])
        return {"train_losses": res["train_losses"], "val_losses": res["val_losses"],
                "test_losses": res["test_losses"],
                "files": sorted(p.name for p in out.iterdir()) if out.exists() else [],
                "ckpt": sorted(p.name for p in Path(c["training"]["save_dir"]).iterdir())
                if Path(c["training"]["save_dir"]).exists() else []}

    out = {}
    if rank == 0:
        out["single"] = run("single")
    os.environ["WORLD_SIZE"] = str(torch.distributed.get_world_size())
    try:  # each rank its own folders, to see what each writes
        out["dp"] = run(f"dp{rank}")
    finally:
        del os.environ["WORLD_SIZE"]
    return out


def _refusals(d):
    from deephisto_tpu_torch.models import ResNet18, ViT
    from deephisto_tpu_torch.models.vit import Block
    from deephisto_tpu_torch.parallel import (
        create_pipeline_state,
        make_mesh,
        make_pipeline_steps,
        make_pp_mesh,
        place_vit_tensor_parallel,
    )
    from deephisto_tpu_torch.train import create_train_state

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    mesh, pp = make_mesh(model=2), make_pp_mesh(stages=2)
    odd = nn.Sequential(Block(5, 1, mlp_ratio=3))
    state = create_pipeline_state(_vit(d, "conv_gn"), pp, 1e-3)
    bad_mb = make_pipeline_steps(_vit(d, "conv_gn"), pp, n_microbatches=3)[0]
    x, y = (torch.from_numpy(a) for a in d["vit_batches"][0])
    return {
        "tp_resnet": message(lambda: place_vit_tensor_parallel(
            create_train_state(ResNet18(num_classes=5, num_filters=8), 1e-3), mesh)),
        "tp_width": message(lambda: place_vit_tensor_parallel(create_train_state(odd, 1e-3), mesh)),
        "pp_bn_stem": message(lambda: make_pipeline_steps(
            ViT(dtype=torch.float32, stem="conv", depth=2, **VIT_KW), pp)),
        "pp_microbatches": message(lambda: bad_mb(state, x, y)),
        "pp_mesh_axes": message(lambda: make_pipeline_steps(_vit(d, "conv_gn"), mesh)),
    }


def _rank_cases(rank, world, path):
    from deephisto_tpu_torch.parallel import make_mesh

    d = torch.load(path, weights_only=False)
    mesh = make_mesh()
    out = _predicts(d, mesh)
    out["tp_linear"] = _tp(d, "linear", world // 2)
    if world == 2:
        out["resnet_dp"] = _resnet_dp(d, mesh)
        out["epoch_dp"] = _fused_epoch_dp(d, mesh)
        out["tp_conv"] = _tp(d, "conv", 1)
        out["pp"] = _pp(d, "conv_gn", 2)
        out["refusals"] = _refusals(d)
        out["train_program"] = _train_program(d["train_cfg"], rank)
    else:
        out["pp"] = _pp(d, "linear4", 2)
    return out


_RANKS = {}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """world -> each rank's readings of :func:`_rank_cases`."""

    def get(world):
        if world not in _RANKS:
            _RANKS[world] = run_ranks(_rank_cases, world, tmp_path_factory.mktemp(f"r{world}"),
                                      inputs["path"])
        return _RANKS[world]

    return get


WORLDS = [2, 4]


# ---- one rank: bit for bit -------------------------------------------------


def test_mesh_predicts_at_one_rank_are_the_single_predicts(world1, inputs):
    from deephisto_tpu_torch.parallel import make_mesh

    got = _predicts(inputs["data"], make_mesh())
    for a, b in (("dp", "dp_single"), ("fcn", "fcn_single"), ("fcn_int8", "fcn_int8_single")):
        np.testing.assert_array_equal(got[a][0], got[b][0])
        assert torch.equal(got[a][1], got[b][1]), a
    np.testing.assert_array_equal(got["sp"], got["sp_single"][0])


# ---- 2 and 4 ranks ---------------------------------------------------------


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for o in ranks[1:]:
        if isinstance(first, tuple):
            np.testing.assert_array_equal(o[key][0], first[0])
            assert torch.equal(torch.as_tensor(o[key][1]), torch.as_tensor(first[1]))
        else:
            np.testing.assert_array_equal(o[key], first)
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_dp_predict_matches_jax(ranks, jax_predicts, world):
    am, scores = _same_on_every_rank(ranks(world), "dp")
    want_am, want_scores = jax_predicts(world)["dp"]
    assert am.dtype == np.uint8
    np.testing.assert_array_equal(am, want_am)
    assert _rel(scores, want_scores) <= SCORE_REL


@pytest.mark.parametrize("world", WORLDS)
def test_dp_predict_matches_the_single_predict(ranks, world):
    am, scores = _same_on_every_rank(ranks(world), "dp")
    want_am, want_scores = ranks(world)[0]["dp_single"]
    np.testing.assert_array_equal(am, want_am)
    assert _rel(scores, want_scores) <= SCORE_REL


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_predict_matches_jax(ranks, jax_predicts, world):
    am = _same_on_every_rank(ranks(world), "sp")
    assert am.dtype == np.uint8
    np.testing.assert_array_equal(am, jax_predicts(world)["sp"])


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_predict_matches_the_single_predict(ranks, world):
    am = _same_on_every_rank(ranks(world), "sp")
    np.testing.assert_array_equal(am, ranks(world)[0]["sp_single"][0])


@pytest.mark.parametrize("model", ["fcn", "fcn_int8"])
@pytest.mark.parametrize("world", WORLDS)
def test_fcn_spatial_matches_the_single_fcn(ranks, world, model):
    am, scores = _same_on_every_rank(ranks(world), model)
    want_am, want_scores = ranks(world)[0][f"{model}_single"]
    assert am.dtype == np.uint8
    np.testing.assert_array_equal(am, want_am)
    np.testing.assert_allclose(scores.numpy(), want_scores.numpy(), rtol=0, atol=FCN_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_fcn_spatial_matches_jax(ranks, jax_predicts, world):
    """The float banded fcn against the JAX one: argmax equal, and the
    banding adds at most 1e-5 to the two frameworks' difference on the
    single fcn (their f32 convs sum in other orders: 5e-5 on this model)."""
    am, scores = ranks(world)[0]["fcn"]
    _, single = ranks(world)[0]["fcn_single"]
    want_am, want_scores = jax_predicts(world)["fcn"]
    _, want_single = jax_predicts(world)["fcn_single"]
    np.testing.assert_array_equal(am, want_am)
    frameworks = float(np.abs(single.numpy() - want_single).max())
    assert frameworks <= 1e-4
    assert float(np.abs(scores.numpy() - want_scores).max()) <= frameworks + FCN_ATOL


def test_dp_resnet_steps_match_jax(ranks, inputs):
    import jax
    import jax.numpy as jnp

    from deephisto_tpu.models.patch_cls_simple.train import make_steps as jax_make_steps
    from deephisto_tpu.parallel import make_mesh as jax_make_mesh
    from deephisto_tpu.parallel import replicated as jax_replicated
    from deephisto_tpu.parallel import shard_batch as jax_shard_batch
    from deephisto_tpu.train import create_train_state as jax_state

    mesh = jax_make_mesh(jax.devices()[:2])
    state = jax.device_put(jax_state(inputs["jtrain"], jax.tree.map(np.array, inputs["vtrain"]),
                                     learning_rate=1e-3), jax_replicated(mesh))
    step, _ = jax_make_steps(inputs["jtrain"], mesh)
    want = []
    for x, y in inputs["data"]["train_batches"]:
        state, loss, _ = step(state, jax_shard_batch(jnp.asarray(x), mesh),
                              jax_shard_batch(jnp.asarray(y.astype(np.int32)), mesh))
        want.append(float(loss))
    for o in ranks(2):
        np.testing.assert_allclose([l for l, _ in o["resnet_dp"]["dp"]], want, rtol=LOSS_RTOL_DP)


def test_dp_resnet_steps_match_the_single_steps(ranks):
    rs = ranks(2)
    single = rs[0]["resnet_dp"]["single"]
    for o in rs:
        dp = o["resnet_dp"]["dp"]
        np.testing.assert_allclose([l for l, _ in dp], [l for l, _ in single], rtol=LOSS_RTOL_DP)
        assert [c for _, c in dp] == [c for _, c in single]


def test_dp_batchnorm_statistics_are_global(ranks):
    rs = ranks(2)
    mean, var = rs[0]["resnet_dp"]["stats"]
    for o in rs[1:]:
        assert torch.equal(o["resnet_dp"]["stats"][0], mean)
        assert torch.equal(o["resnet_dp"]["stats"][1], var)
    s_mean, s_var = rs[0]["resnet_dp"]["stats_single"]
    assert _rel(mean, s_mean) <= 1e-4 and _rel(var, s_var) <= 1e-4


def test_dp_fused_epoch_matches_the_single_epoch(ranks):
    rs = ranks(2)
    losses, corrects = rs[0]["epoch_dp"]["single"]
    for o in rs:
        got_l, got_c = o["epoch_dp"]["dp"]
        np.testing.assert_allclose(got_l.numpy(), losses.numpy(), rtol=LOSS_RTOL_DP)
        assert torch.equal(got_c, corrects)


@pytest.mark.parametrize("world,stem", [(2, "linear"), (2, "conv"), (4, "linear")])
def test_tp_steps_match_the_single_steps(ranks, world, stem):
    for o in ranks(world):
        tp = o[f"tp_{stem}"]
        np.testing.assert_allclose([l for l, _ in tp["tp"]], [l for l, _ in tp["single"]],
                                   rtol=LOSS_RTOL)
        assert [c for _, c in tp["tp"]] == [c for _, c in tp["single"]]


@pytest.mark.parametrize("world", WORLDS)
def test_tp_shards_live_on_their_ranks(ranks, world):
    for o in ranks(world):
        tp = o["tp_linear"]
        assert tp["fc1"] == tp["mu_fc1"] == (4 * 64 // 2, 64)
        assert tp["canon"] == tp["model"]
        assert tp["fc_rel"] <= 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_pp_steps_match_the_single_steps(ranks, world):
    for o in ranks(world):
        pp = o["pp"]
        np.testing.assert_allclose([l for l, _ in pp["pp"]], [l for l, _ in pp["single"]],
                                   rtol=LOSS_RTOL)
        assert [c for _, c in pp["pp"]] == [c for _, c in pp["single"]]


@pytest.mark.parametrize("world", WORLDS)
def test_pp_eval_and_canonical_params(ranks, world):
    for o in ranks(world):
        assert o["pp"]["n_blocks"] == 4 // 2
        assert o["pp"]["eval_vs_canonical"] <= 1e-5


def test_train_program_under_torchrun_matches_one_process(ranks):
    """``train(cfg)`` with ``WORLD_SIZE`` 2 makes its mesh and trains on the
    same global batches as one process, and only rank 0 writes files. The
    trainer's model computes in bf16, where the global batch statistics
    (flax's E[x²] − E[x]²) and torch's one-process batch norm round the
    normalised activations differently: the first step's loss (before any
    update) within rtol 1e-3 (measured 1.4e-4). Every loss after an Adam
    step within rtol 2e-3: Adam's first steps move each parameter by about
    ±lr whatever its gradient's size, so differences at rounding level grow
    (float32, make_fused_epoch over this sampler: 2.3e-4 on the third step,
    where SGD agrees to 2e-7)."""
    rs = ranks(2)
    single = rs[0]["train_program"]["single"]
    for r, o in enumerate(rs):
        dp = o["train_program"]["dp"]
        np.testing.assert_allclose(dp["train_losses"][0], single["train_losses"][0], rtol=1e-3)
        for key in ("train_losses", "val_losses", "test_losses"):
            np.testing.assert_allclose(dp[key], single[key], rtol=ADAM_RTOL)
        if r == 0:
            assert dp["files"] == single["files"] and "best_model.msgpack" in dp["files"]
            assert dp["ckpt"] == single["ckpt"] == ["last_state.msgpack"]
        else:
            assert dp["files"] == [] and dp["ckpt"] == []


@pytest.mark.parametrize("case,match", [
    ("tp_resnet", "ViT family"),
    ("tp_width", "not divisible by model axis 2"),
    ("pp_bn_stem", "conv_gn"),
    ("pp_microbatches", "not divisible by n_microbatches=3"),
    ("pp_mesh_axes", "mesh must have"),
])
def test_parallel_refusals(ranks, case, match):
    import re

    for o in ranks(2):
        assert o["refusals"][case] is not None and re.search(match, o["refusals"][case]), (
            case, o["refusals"][case])
