"""The port's parallel wiring (``deephisto_tpu_torch/parallel``) on the CPU:
the pure functions against the JAX package's, the mesh and the collectives
on real process groups.

* ``band_partition``, ``shard_slides``, the tensor-parallel spec of every
  ViT parameter and ``split_vit_params`` equal to the JAX package's (the
  specs and stacked blocks in torch's layout: a Linear weight is the flax
  kernel transposed), and the refusals of the pure functions.
* At one rank, in this process (a gloo group of one over a ``FileStore``):
  the meshes' shapes and refusals. ``initialize()`` from a torchrun
  environment (2 spawned ranks over localhost).
* At 2 and 4 ranks, spawned with ``torch.multiprocessing`` into a gloo
  group over a ``FileStore`` under ``tmp_path`` (one spawn a world size,
  2 threads a rank, a timeout on the join): the meshes and batch shardings,
  ``replicated``, the gradient-carrying collectives of ``_comm.py`` (each
  forward and backward against the sum or the shift it stands for, exact),
  the gathers, the fcn bands' halo hop, and the cross-rank BatchNorm against
  the one-process BatchNorm of the global batch (float32: outputs, input and
  parameter gradients and running statistics within 1e-5 of their scale;
  the sums run in another order).

The ranks import no JAX: this module imports it only inside the tests.
:func:`run_ranks` is the spawn harness ``test_torch_spatial.py`` shares.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deephisto_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    band_partition,
    batch_sharding,
    global_band_mesh,
    global_batch_sharding,
    initialize,
    make_global_mesh,
    make_mesh,
    make_pp_mesh,
    merge_vit_params,
    replicated,
    shard_batch,
    shard_slides,
    split_vit_params,
)
from deephisto_tpu_torch.parallel import _comm
from deephisto_tpu_torch.parallel.tensor import vit_tp_spec

RANK_THREADS = 2
JOIN_TIMEOUT = 240


def _rank_entry(rank, world, store, out, fn, args):
    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        # this torch build's oneDNN backward of channels_last convs corrupts
        # memory at some shapes (tests/test_torch_train.py)
        with torch.backends.mkldnn.flags(enabled=False):
            result = fn(rank, world, *args)
        torch.save(result, f"{out}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of a gloo group
    over a FileStore under ``tmp_path``; each rank's return value, by rank.
    A rank's exception fails the call with its traceback (the others are
    terminated); the join times out after ``timeout`` seconds."""
    tag = f"{getattr(fn, '__name__', 'fn')}_{world}"
    store, out = str(tmp_path / f"store_{tag}"), str(tmp_path / f"out_{tag}")
    _join(mp.start_processes(_rank_entry, args=(world, store, out, fn, args), nprocs=world,
                             join=False, start_method="spawn"), timeout, tag)
    return [torch.load(f"{out}_{r}.pt", weights_only=False) for r in range(world)]


def _join(ctx, timeout: float, tag: str) -> None:
    """Join spawned ranks; kill them and fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks of {tag} did not finish in {timeout} s")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one rank in this process."""
    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


# ---- pure functions against the JAX package ------------------------------


def test_initialize_returns_false_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    assert initialize() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("h,n,ps,halo", [(512, 8, 32, 0), (160, 2, 64, 0), (1000, 3, 224, 16),
                                         (100, 4, 32, 8)])
def test_band_partition_matches_jax(h, n, ps, halo):
    from deephisto_tpu.parallel.spatial import band_partition as jax_band_partition

    got, want = band_partition(h, n, ps, halo), jax_band_partition(h, n, ps, halo)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


@pytest.mark.parametrize("n_paths,count", [(10, 3), (5, 2), (3, 4)])
def test_shard_slides_matches_jax(n_paths, count):
    from deephisto_tpu.parallel import shard_slides as jax_shard_slides

    paths = [f"slide_{i}" for i in range(n_paths)]
    parts = [shard_slides(paths, process_id=p, process_count=count) for p in range(count)]
    assert parts == [jax_shard_slides(paths, process_id=p, process_count=count)
                     for p in range(count)]
    assert sorted(sum(parts, [])) == sorted(paths)


def _jax_and_torch_vit(stem, depth=2):
    import jax
    import jax.numpy as jnp
    from test_torch_resnet import _random_variables

    from deephisto_tpu.models.vit import ViT as JViT
    from deephisto_tpu_torch.models import ViT, flax_vit_to_torch

    kw = dict(num_classes=5, patch=8, dim=32, depth=depth, heads=2)
    jm = JViT(dtype=jnp.float32, stem=stem, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)))
    v = _random_variables(shapes, np.random.default_rng(0))
    tm = ViT(dtype=torch.float32, stem=stem, img_size=16, **kw)
    tm.load_state_dict(flax_vit_to_torch(v))
    return v, tm


@pytest.mark.parametrize("stem", ["linear", "conv", "conv_gn"])
def test_tp_spec_of_every_parameter_matches_jax(stem):
    """The port's spec of each parameter is the JAX spec of its flax leaf in
    torch's layout: a Dense kernel's two axes swapped."""
    import jax.tree_util as jtu

    from deephisto_tpu.parallel.tensor import vit_tp_spec as jax_spec

    v, tm = _jax_and_torch_vit(stem)
    want = {}
    for path, x in jtu.tree_leaves_with_path(v["params"]):
        *mods, leaf = [p.key for p in path]
        spec = tuple(jax_spec(path, x))
        if leaf == "kernel" and x.ndim == 2 and spec:
            spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
        want[".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])] = spec
    got = {name: vit_tp_spec(name, p) for name, p in tm.named_parameters()}
    assert got == want
    assert sum(MODEL_AXIS in s for s in got.values()) == 3 * 2  # fc1 w, b, fc2 w; 2 blocks


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_split_vit_params_matches_jax(n_stages):
    """Stage s holds blocks s·K … s·K+K-1 on a leading [S, K] axis, as the
    JAX split does, and the merge inverts the split."""
    from deephisto_tpu.parallel.pipeline import split_vit_params as jax_split

    v, tm = _jax_and_torch_vit("conv_gn", depth=4)
    params = tm.state_dict()
    shared, stacked = split_vit_params(params, n_stages)
    j_shared, j_stacked = jax_split(v["params"], n_stages)
    assert {k.split(".")[0] for k in shared} == set(j_shared)
    k = 4 // n_stages
    j_ln1 = np.asarray(j_stacked["ln1"]["scale"])
    assert stacked["ln1.weight"].shape == j_ln1.shape == (n_stages, k, 32)
    np.testing.assert_array_equal(stacked["ln1.weight"].numpy(), j_ln1)
    np.testing.assert_array_equal(stacked["fc1.weight"].numpy(),
                                  np.swapaxes(np.asarray(j_stacked["fc1"]["kernel"]), -1, -2))
    merged = merge_vit_params(shared, stacked)
    assert merged.keys() == params.keys()
    for name in params:
        assert torch.equal(merged[name], params[name]), name


@pytest.mark.parametrize("params,match", [("depth4", "does not divide"),
                                          ({"conv1.weight": torch.zeros(1)}, "ViT family")])
def test_split_vit_params_refusals(params, match):
    if params == "depth4":
        params = _jax_and_torch_vit("linear", depth=4)[1].state_dict()
    with pytest.raises(ValueError, match=match):
        split_vit_params(params, 3)


# ---- one rank in this process ---------------------------------------------


def test_meshes_at_one_rank(world1):
    m = make_mesh()
    assert m.mesh_dim_names == (DATA_AXIS, MODEL_AXIS) and tuple(m.shape) == (1, 1)
    with pytest.raises(ValueError, match="0x2 != 1 ranks"):
        make_mesh(model=2)
    g = make_global_mesh()
    assert g.mesh_dim_names == ("host", DATA_AXIS, MODEL_AXIS) and tuple(g.shape) == (1, 1, 1)
    n_bands, group = global_band_mesh(g)
    assert n_bands == 1 and dist.get_world_size(group) == 1
    assert initialize() is True  # idempotent: the group is live


def test_pp_mesh_refuses_stages_that_do_not_divide(world1):
    assert tuple(make_pp_mesh(stages=1).shape) == (1, 1)
    with pytest.raises(ValueError, match="do not divide"):
        make_pp_mesh(stages=2)


def test_batch_sharding_at_one_rank_keeps_the_batch(world1):
    m = make_mesh()
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(shard_batch(x, m), x)
    assert batch_sharding(m).rows(6) == slice(0, 6)


# ---- 2 and 4 ranks ---------------------------------------------------------


def _torchrun_rank(rank, world, port, out):
    """A rank as torchrun starts it: the environment only, no group."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    joined = initialize()
    try:
        mesh = make_global_mesh()
        x = torch.full((1,), float(rank + 1))
        dist.all_reduce(x)
        torch.save({"joined": joined, "again": initialize(), "backend": dist.get_backend(),
                    "shape": tuple(mesh.shape), "sum": float(x), "slides": shard_slides(
                        [f"s{i}" for i in range(5)])}, f"{out}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_initialize_from_the_torchrun_environment(tmp_path):
    """``initialize()`` joins the group torchrun's variables describe (over
    localhost), gloo without a card, idempotently; the global mesh spans
    one node; ``shard_slides`` takes the rank's round-robin share."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    _join(mp.start_processes(_torchrun_rank, args=(2, port, str(tmp_path / "out")), nprocs=2,
                             join=False, start_method="spawn"), JOIN_TIMEOUT, "torchrun")
    for r in range(2):
        o = torch.load(tmp_path / f"out_{r}.pt")
        assert o["joined"] is True and o["again"] is True and o["backend"] == "gloo"
        assert o["shape"] == (1, 2, 1) and o["sum"] == 3.0
        assert o["slides"] == [f"s{i}" for i in range(r, 5, 2)]


def _bn_reference(x, weight, bias):
    """The one-process BatchNorm of the global batch: (output, running mean
    and var after one step, x's gradient, weight's and bias's) for the
    upstream gradient ``cos(y)``."""
    from deephisto_tpu_torch.models.resnet import BatchNorm

    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xg = x.clone().requires_grad_(True)
    y = bn.train()(xg)
    y.backward(torch.cos(y.detach()))
    return (y.detach(), bn.running_mean.clone(), bn.running_var.clone(), xg.grad,
            bn.weight.grad, bn.bias.grad)


def _comm_cases(rank, world):
    """Every check of this file at ``world`` ranks; each rank returns its
    readings (compared by the tests)."""
    from deephisto_tpu_torch.models.resnet import BatchNorm, sync_batchnorm

    out = {}
    mesh = make_mesh()
    g = mesh.get_group(DATA_AXIS)
    out["mesh_shape"] = tuple(mesh.shape)
    out["mesh_tp_shape"] = tuple(make_mesh(model=2).shape)
    out["data_rank"] = mesh.get_local_rank(DATA_AXIS)
    out["shard"] = shard_batch(torch.arange(4 * world).reshape(2 * world, 2), mesh)

    # replicated: rank 0's weights on every rank
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank))
    out["replicated"] = replicated(lin, mesh).weight.detach().clone()

    # all_reduce_sum: forward Σ, backward Σ of the upstream gradients
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = _comm.all_reduce_sum(x, g)
    (y * (rank + 1)).sum().backward()
    out["all_reduce_sum"] = (y.detach(), x.grad.clone())

    # Megatron's pair
    x = torch.full((2,), float(rank + 1), requires_grad=True)
    y = _comm.copy_to_group(x, g)
    (y * (rank + 1)).sum().backward()
    out["copy_to"] = (y.detach(), x.grad.clone())
    x = torch.full((2,), float(rank + 1), requires_grad=True)
    y = _comm.reduce_from_group(x, g)
    (y * (rank + 1)).sum().backward()
    out["reduce_from"] = (y.detach(), x.grad.clone())

    # the pipeline hop and its backward; the fcn bands' halo hop
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = _comm.shift(x, g)
    (y * (rank + 1)).sum().backward()
    out["shift"] = (y.detach(), x.grad.clone())
    out["halo"] = _comm.halo_from_next(torch.full((2,), float(rank + 1)), g)

    # gathers
    out["gather_rows"] = _comm.gather_rows(torch.full((2, 2), float(rank)), g)
    out["gather_dim"] = _comm.gather_dim(torch.full((2, 1), float(rank)), 1, g)

    # global mesh: two "nodes" of world/2 ranks
    os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)
    gm = make_global_mesh()
    bs = global_batch_sharding(gm)
    out["global_mesh"] = (tuple(gm.shape), bs.index, bs.count, global_band_mesh(gm)[0])
    del os.environ["LOCAL_WORLD_SIZE"]

    # cross-rank BatchNorm on this rank's rows of a global batch
    gen = torch.Generator().manual_seed(0)
    xg = torch.randn(4 * world, 6, 5, 5, generator=gen) * 2 + 1
    weight, bias = torch.rand(6, generator=gen) + 0.5, torch.randn(6, generator=gen)
    bn = sync_batchnorm(BatchNorm(6), g)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    xl = shard_batch(xg, mesh).clone().requires_grad_(True)
    yl = bn.train()(xl)
    yl.backward(torch.cos(yl.detach()))
    wgrad = _comm.all_reduce_(bn.weight.grad.clone(), g)
    bgrad = _comm.all_reduce_(bn.bias.grad.clone(), g)
    out["bn"] = (yl.detach(), bn.running_mean.clone(), bn.running_var.clone(), xl.grad,
                 wgrad, bgrad)
    out["bn_ref"] = _bn_reference(xg, weight, bias)
    with torch.no_grad():
        out["bn_eval"] = bn.eval()(xl.detach())  # eval mode: no collective
    return out


_RESULTS = {}


@pytest.fixture(scope="module")
def comm(tmp_path_factory):
    """world -> each rank's readings of :func:`_comm_cases`."""

    def get(world):
        if world not in _RESULTS:
            _RESULTS[world] = run_ranks(_comm_cases, world, tmp_path_factory.mktemp(f"c{world}"))
        return _RESULTS[world]

    return get


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shapes_and_shards(comm, world):
    ranks = comm(world)
    for r, o in enumerate(ranks):
        assert o["mesh_shape"] == (world, 1) and o["mesh_tp_shape"] == (world // 2, 2)
        assert o["data_rank"] == r
        assert torch.equal(o["shard"], torch.arange(4 * world).reshape(2 * world, 2)[2 * r:2 * r + 2])


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_broadcasts_rank0(comm, world):
    for o in comm(world):
        assert torch.equal(o["replicated"], torch.zeros(2, 3))


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_sum_and_its_gradient(comm, world):
    total = sum(range(1, world + 1))
    for o in comm(world):
        y, gx = o["all_reduce_sum"]
        assert torch.equal(y, torch.full((3,), float(total)))
        assert torch.equal(gx, torch.full((3,), float(total)))


@pytest.mark.parametrize("world", WORLDS)
def test_megatron_copy_and_reduce(comm, world):
    total = sum(range(1, world + 1))
    for r, o in enumerate(comm(world)):
        y, gx = o["copy_to"]
        assert torch.equal(y, torch.full((2,), float(r + 1)))
        assert torch.equal(gx, torch.full((2,), float(total)))
        y, gx = o["reduce_from"]
        assert torch.equal(y, torch.full((2,), float(total)))
        assert torch.equal(gx, torch.full((2,), float(r + 1)))


@pytest.mark.parametrize("world", WORLDS)
def test_shift_forward_and_backward(comm, world):
    """Rank i gets rank i-1's tensor (rank 0 zeros); x's gradient is rank
    i+1's upstream gradient, (i+2), and zero on the last rank."""
    for r, o in enumerate(comm(world)):
        y, gx = o["shift"]
        assert torch.equal(y, torch.full((2, 3), float(r)))
        assert torch.equal(gx, torch.full((2, 3), float(r + 2 if r < world - 1 else 0)))


@pytest.mark.parametrize("world", WORLDS)
def test_halo_hop(comm, world):
    for r, o in enumerate(comm(world)):
        assert torch.equal(o["halo"], torch.full((2,), float(r + 2 if r < world - 1 else 0)))


@pytest.mark.parametrize("world", WORLDS)
def test_gathers(comm, world):
    want = torch.arange(world, dtype=torch.float32).repeat_interleave(2)
    for o in comm(world):
        assert torch.equal(o["gather_rows"], want[:, None].expand(2 * world, 2))
        assert torch.equal(o["gather_dim"], torch.arange(world, dtype=torch.float32).expand(2, world))


@pytest.mark.parametrize("world", WORLDS)
def test_global_mesh_over_two_nodes(comm, world):
    for r, o in enumerate(comm(world)):
        shape, index, count, n_bands = o["global_mesh"]
        assert shape == (2, world // 2, 1)
        assert (index, count, n_bands) == (r, world, world)


@pytest.mark.parametrize("world", WORLDS)
def test_cross_rank_batchnorm_is_the_global_batch_norm(comm, world):
    ranks = comm(world)
    y_ref, rm_ref, rv_ref, gx_ref, gw_ref, gb_ref = ranks[0]["bn_ref"]
    per = y_ref.shape[0] // world
    for r, o in enumerate(ranks):
        y, rm, rv, gx, gw, gb = o["bn"]
        rows = slice(r * per, (r + 1) * per)
        for got, want in ((y, y_ref[rows]), (rm, rm_ref), (rv, rv_ref), (gx, gx_ref[rows]),
                          (gw, gw_ref), (gb, gb_ref)):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("world", WORLDS)
def test_batchnorm_eval_mode_uses_running_statistics(comm, world):
    """Eval mode does not sync: each rank normalises its rows with the
    (same) running statistics."""
    ranks = comm(world)
    y0 = torch.cat([o["bn_eval"] for o in ranks])
    _, rm, rv, _, _, _ = ranks[0]["bn"]
    xg = torch.cat([o["bn"][0] for o in ranks])  # shapes only
    assert y0.shape == xg.shape
    for o in ranks:
        assert torch.equal(o["bn"][1], rm) and torch.equal(o["bn"][2], rv)
