"""``deephisto_tpu_torch.train.dist_ckpt``: sharded, async, mesh-portable,
rotating train-state checkpoints on ``torch.distributed.checkpoint``, the
port's counterpart of ``train/orbax_ckpt.py`` (tests/test_checkpoint_orbax.py
holds that one), on the CPU.

* An async save restores bit for bit (parameters, BatchNorm statistics,
  Adam's moments and step, the learning rate, the step count, epoch and
  extra); rotation keeps ``max_to_keep`` completed steps; a run resumed from
  a step continues bit-equal to the uninterrupted run; a directory with no
  step raises ``FileNotFoundError``.
* Two gloo ranks (one spawn): a tensor-parallel (``model=2``) step keeps
  the replicated parameters and their moments bit-equal on both ranks when
  one rank's gradients are off in their last bits; its save restores
  into a single-device state bit-equal to the canonical gather
  (``vit_tp_state_dict``), and a single-device save into the sharded state;
  a 2-stage pipeline save restores into a single state bit-equal to
  ``pipeline_params_to_canonical``; a 2-rank data-parallel save holds each
  replicated tensor once (its bytes within 5 % of a world-1 save) and
  restores at world 1.
* ``load_model`` of a state built from the JAX package's weights returns
  those weights exactly, in flax's layout; the daemon serves a checkpoint
  directory (``ServingEngine.from_checkpoint``) as the JAX daemon serves its
  orbax directory of the same weights (class equal, probabilities within
  1e-5).

The ranks import no JAX: this module imports it only inside the tests.
"""

import numpy as np
import pytest
import torch

from deephisto_tpu_torch.models import ResNet18, ViT
from deephisto_tpu_torch.train import create_train_state
from deephisto_tpu_torch.train import dist_ckpt as dc

from test_torch_parallel import run_ranks

VIT_KW = dict(num_classes=5, patch=8, dim=32, depth=2, heads=2, dtype=torch.float32,
              img_size=32)


@pytest.fixture(autouse=True)
def no_onednn():
    # this torch build's oneDNN backward of channels_last convs corrupts
    # memory at some shapes (tests/test_torch_train.py)
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _batches(n, size=32, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 5, b).astype(np.int64))) for _ in range(n)]


def _vit(seed=0):
    torch.manual_seed(seed)
    return ViT(**VIT_KW)


def _resnet(seed=0):
    torch.manual_seed(seed)
    return ResNet18(num_classes=5, num_filters=8, dtype=torch.float32)


def _steps(state, batches, mesh=None):
    from deephisto_tpu_torch.models.patch_cls_simple import make_steps

    step = make_steps(state.model, mesh)[0]
    losses = []
    for x, y in batches:
        state, loss, _ = step(state, x, y)
        losses.append(float(loss))
    return losses


def _moments(state):
    opt = state.optimizer
    return {n: {k: v.clone() for k, v in opt.state[p].items()}
            for n, p in state.model.named_parameters()}


def _assert_state_equal(a, b):
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    ma, mb = _moments(a), _moments(b)
    assert ma.keys() == mb.keys()
    for n in ma:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ma[n][k], mb[n][k]), (n, k)
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    assert a.step == b.step


def test_async_roundtrip_is_bit_equal(tmp_path):
    state = create_train_state(_resnet(), 1e-3, weight_decay=1e-4)  # AdamW
    _steps(state, _batches(2))
    state.optimizer.param_groups[0]["lr"] = 3e-4
    mgr = dc.checkpoint_manager(tmp_path / "ck")
    assert dc.save_train_state(mgr, 2, state, epoch=1, extra={"best_val": 0.5})
    mgr.wait_until_finished()
    assert dc.latest_step(mgr) == 2 and (tmp_path / "ck" / "2" / ".metadata").is_file()
    fresh = create_train_state(_resnet(seed=1), 1e-3, weight_decay=1e-4)
    fresh, epoch, extra = dc.restore_train_state(mgr, fresh)
    mgr.close()
    assert (epoch, extra) == (1, {"best_val": 0.5})
    _assert_state_equal(state, fresh)


def test_rotation_and_save_interval(tmp_path):
    state = create_train_state(_vit(), 1e-3)
    _steps(state, _batches(1))
    mgr = dc.checkpoint_manager(tmp_path, max_to_keep=2, save_interval_steps=2)
    assert not dc.save_train_state(mgr, 3, state, epoch=0)  # not due
    for step in (2, 4, 6):
        assert dc.save_train_state(mgr, step, state, epoch=step)
    assert not dc.save_train_state(mgr, 6, state, epoch=6)  # saved already
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 6]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "6"]
    _, epoch, _ = dc.restore_train_state(mgr, create_train_state(_vit(1), 1e-3), step=4)
    assert epoch == 4


def test_resume_continues_bit_equal(tmp_path):
    batches = _batches(4, seed=3)
    run = create_train_state(_vit(), 1e-3)
    _steps(run, batches[:2])
    mgr = dc.checkpoint_manager(tmp_path)
    dc.save_train_state(mgr, run.step, run, epoch=0)
    want = _steps(run, batches[2:])  # the write runs while these steps do
    mgr.wait_until_finished()
    resumed, _, _ = dc.restore_train_state(mgr, create_train_state(_vit(7), 1e-3))
    assert resumed.step == 2
    assert _steps(resumed, batches[2:]) == want
    _assert_state_equal(run, resumed)


def test_no_step_raises(tmp_path):
    mgr = dc.checkpoint_manager(tmp_path / "empty")
    assert dc.latest_step(mgr) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        dc.restore_train_state(mgr, create_train_state(_vit(), 1e-3))
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        dc.load_model(tmp_path / "empty")


# -- two ranks --------------------------------------------------------------

def _mesh_ranks(rank, world, root):
    """TP, PP and DP states on 2 gloo ranks, each saved (async); the TP
    state also restored from a world-1 save. Returns what the parent holds
    them to."""
    from pathlib import Path

    from deephisto_tpu_torch.parallel import (
        create_pipeline_state,
        make_mesh,
        make_pipeline_steps,
        make_pp_mesh,
        pipeline_params_to_canonical,
        place_vit_tensor_parallel,
    )
    from deephisto_tpu_torch.parallel.tensor import (
        replicated_parameters,
        vit_tp_spec,
        vit_tp_state_dict,
    )

    root, out = Path(root), {}
    batches = _batches(1, seed=5)

    mesh = make_mesh(data=1, model=2)
    tp = place_vit_tensor_parallel(create_train_state(_vit(), 1e-3), mesh)
    # rank 1's replicated gradients off in their last bits, as a card's
    # cuDNN weight gradient may leave them: the step must keep the replicas
    # equal all the same
    hooks = [p.register_hook(lambda g: g * (1 + 2.0 ** -20))
             for p in replicated_parameters(tp.model) if rank == 1]
    _steps(tp, batches, mesh)
    for h in hooks:
        h.remove()
    out["tp_replicated"] = {n: t.clone() for n, t in tp.model.state_dict().items()
                            if vit_tp_spec(n, t) == ()}
    out["tp_replicated_moments"] = {n: m for n, m in _moments(tp).items()
                                    if vit_tp_spec(n, tp.model.get_parameter(n)) == ()}
    mgr = dc.checkpoint_manager(root / "tp")
    dc.save_train_state(mgr, 1, tp, epoch=0)
    mgr.wait_until_finished()
    out["tp_canonical"] = vit_tp_state_dict(tp.model, mesh)
    back = place_vit_tensor_parallel(create_train_state(_vit(3), 1e-3), mesh)
    dc.restore_train_state(mgr, back)  # the sharded save into a sharded state
    _assert_state_equal(tp, back)
    single = place_vit_tensor_parallel(create_train_state(_vit(3), 1e-3), mesh)
    dc.restore_train_state(dc.checkpoint_manager(root / "world1"), single)
    out["tp_from_world1"] = {n: t.clone() for n, t in single.model.state_dict().items()}

    pmesh = make_pp_mesh(stages=2)
    pp = create_pipeline_state(_vit(), pmesh, 1e-3)
    train_step, _ = make_pipeline_steps(_vit(), pmesh, n_microbatches=2)
    train_step(pp, *batches[0])
    mgr = dc.checkpoint_manager(root / "pp")
    dc.save_train_state(mgr, 1, pp, epoch=0)
    mgr.wait_until_finished()
    out["pp_canonical"] = pipeline_params_to_canonical(pp, pmesh)

    dmesh = make_mesh()
    dp = create_train_state(_vit(), 1e-3)
    _steps(dp, batches, dmesh)
    mgr = dc.checkpoint_manager(root / "dp")
    dc.save_train_state(mgr, 1, dp, epoch=0)
    mgr.close()
    out["dp"] = {n: t.clone() for n, t in dp.model.state_dict().items()}
    return out


def _bytes(path):
    return sum(p.stat().st_size for p in path.iterdir() if p.suffix == ".distcp")


def test_two_ranks_tp_pp_dp(tmp_path):
    from deephisto_tpu_torch.parallel.tensor import vit_tp_spec

    world1 = create_train_state(_vit(), 1e-3)
    _steps(world1, _batches(1, seed=9))
    mgr = dc.checkpoint_manager(tmp_path / "world1", async_save=False)
    dc.save_train_state(mgr, 1, world1, epoch=0)

    ranks = run_ranks(_mesh_ranks, 2, tmp_path, str(tmp_path))

    # TP: the replicas are bit-equal on both ranks (rank 1's gradients were
    # perturbed); the sharded save at world 1 is the canonical gather; the world-1
    # save restored into each rank's shards is their cut
    for n, t in ranks[0]["tp_replicated"].items():
        assert torch.equal(t, ranks[1]["tp_replicated"][n]), n
    for n, m in ranks[0]["tp_replicated_moments"].items():
        for k, v in m.items():
            assert torch.equal(v, ranks[1]["tp_replicated_moments"][n][k]), (n, k)
    canon = ranks[0]["tp_canonical"]
    single = create_train_state(_vit(5), 1e-3)
    dc.restore_train_state(dc.checkpoint_manager(tmp_path / "tp"), single)
    for n, t in single.model.state_dict().items():
        assert torch.equal(t, canon[n]), n
    for r, got in enumerate(ranks):
        for n, t in world1.model.state_dict().items():
            spec = vit_tp_spec(n, t)
            want = t.chunk(2, dim=spec.index("model"))[r] if "model" in spec else t
            assert torch.equal(got["tp_from_world1"][n], want), (r, n)

    # PP: the stages' blocks restore into one state under their global names
    single = create_train_state(_vit(5), 1e-3)
    dc.restore_train_state(dc.checkpoint_manager(tmp_path / "pp"), single)
    for n, t in single.model.state_dict().items():
        assert torch.equal(t, ranks[0]["pp_canonical"][n]), n

    # DP: the replicas are written once, and restore at world 1
    dp, one = tmp_path / "dp" / "1", tmp_path / "world1" / "1"
    assert abs(_bytes(dp) - _bytes(one)) <= 0.05 * _bytes(one), (_bytes(dp), _bytes(one))
    single = create_train_state(_vit(5), 1e-3)
    dc.restore_train_state(dc.checkpoint_manager(tmp_path / "dp"), single)
    for n, t in single.model.state_dict().items():
        assert torch.equal(t, ranks[0]["dp"][n]) and torch.equal(t, ranks[1]["dp"][n]), n


# -- the JAX package's weights, and the daemon ------------------------------

def test_load_model_returns_the_jax_weights(tmp_path):
    import jax
    import jax.numpy as jnp

    from deephisto_tpu.models.resnet import ResNet18 as JResNet18
    from deephisto_tpu_torch.models import flax_resnet_to_torch
    from test_torch_resnet import _random_variables

    jm = JResNet18(num_classes=5, num_filters=8, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    v = _random_variables(shapes, np.random.default_rng(0))
    model = _resnet()
    model.load_state_dict(flax_resnet_to_torch(v))
    mgr = dc.checkpoint_manager(tmp_path)
    dc.save_train_state(mgr, 0, create_train_state(model, 1e-3), epoch=0)
    mgr.close()
    got = dc.load_model(tmp_path)
    leaves = jax.tree_util.tree_leaves_with_path
    want = dict(leaves(v))
    assert dict(leaves(got)).keys() == want.keys()
    for path, x in leaves(got):
        assert x.dtype == np.float32 and np.array_equal(x, want[path]), path


def test_daemon_serves_a_checkpoint_directory_as_the_jax_daemon(tmp_path):
    import jax
    import jax.numpy as jnp
    import yaml

    from deephisto_tpu.models.patch_cls_simple.model import get_model as jax_get_model
    from deephisto_tpu.serve import ServingEngine as JaxEngine
    from deephisto_tpu.train import create_train_state as jax_create_train_state
    from deephisto_tpu.train import orbax_ckpt as oc
    from deephisto_tpu_torch.models import flax_resnet_to_torch
    from deephisto_tpu_torch.models.patch_cls_simple import get_model
    from deephisto_tpu_torch.serve import ServingEngine
    from test_torch_serve import FCN, NC, PS

    real = jax_get_model(NC, depth=18, stem="s2d")
    rv = real.init(jax.random.key(1), jnp.zeros((1, PS, PS, 3)))
    mgr = oc.checkpoint_manager(tmp_path / "orbax", async_save=False)
    oc.save_train_state(mgr, 5, jax_create_train_state(real, rv, learning_rate=1e-3), epoch=2)
    mgr.close()
    model = get_model(NC, depth=18, stem="s2d")
    model.load_state_dict(flax_resnet_to_torch(jax.tree.map(np.asarray, rv)))
    mgr = dc.checkpoint_manager(tmp_path / "dcp", async_save=False)
    dc.save_train_state(mgr, 5, create_train_state(model, 1e-3), epoch=2)

    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"n_classes": NC, "depth": 18, "stem": "s2d"},
                                   "dataset": {"patch_size": PS}}))
    img = np.random.default_rng(9).integers(0, 255, (PS, PS, 3), dtype=np.uint8)
    want = JaxEngine.from_checkpoint(cfg, tmp_path / "orbax", patch_lanes=1,
                                     **FCN).predict_patch(img)
    eng = ServingEngine.from_checkpoint(cfg, tmp_path / "dcp", device="cpu", patch_lanes=1,
                                        **FCN)
    try:
        got = eng.predict_patch(img)
    finally:
        eng.close()
    assert got["class"] == want["class"]
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=1e-5)
