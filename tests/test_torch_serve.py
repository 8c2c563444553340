"""The port's serving daemon (``deephisto_tpu_torch/serve/``), case for case as
``tests/test_serve.py`` holds the JAX package's: engine parity with the
direct predict calls in every mode, staging and its LRU, the HTTP wire
contract on a loopback server, checkpoint loading, patch coalescing, the
int8 engines and the ViT's fallback, all on the CPU (``device="cpu"``).

What the daemon returns over the wire must equal what the library returns
in-process: maps are compared with ``array_equal``, patch answers with
``==``. A daemon built in each package from one flax msgpack checkpoint
(``save_model`` of the JAX package) answers ``/v1/slide`` with equal maps
(fcn and dense; the random predicts draw from different generators).

Each fixture that starts a server shuts it down and closes its socket, and
each engine that served a patch stops its batcher thread: no thread or port
outlives its test module.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _random_variables
from test_torch_streaming import narrow_resnet

from deephisto_tpu_torch._imageio import encode_png
from deephisto_tpu_torch.models import ViT
from deephisto_tpu_torch.models.quantize import QuantizedResNet
from deephisto_tpu_torch.models.resnet import Bottleneck, ResNet
from deephisto_tpu_torch.predict import (
    predict_full_fcn,
    predict_full_fcn_streamed,
    predict_full_fused,
    predict_full_random_fused,
)
from deephisto_tpu_torch.serve import ServingEngine
from deephisto_tpu_torch.serve import engine as eng_mod
from deephisto_tpu_torch.serve.engine import _load_calib, _PatchBatcher
from deephisto_tpu_torch.serve.server import serve_in_thread
from deephisto_tpu_torch.slide.base import _resize_uint8

H, W = 160, 130
PS = 64
NC = 5
FCN = dict(tile=64, halo=32, tile_batch=2)
CFG = {"model": {"n_classes": NC, "depth": 18, "stem": "s2d"}, "dataset": {"patch_size": PS}}


@pytest.fixture(scope="module")
def model():
    return narrow_resnet("s2d")[2]


@pytest.fixture(scope="module")
def engine(model):
    eng = ServingEngine(model, CFG, device="cpu", **FCN)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(11).integers(0, 255, (H, W, 3), dtype=np.uint8)


def _serve(engine):
    srv, base = serve_in_thread(engine)
    return srv, base


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def http(engine):
    srv, base = _serve(engine)
    yield base
    _stop(srv)


def _post(url, body, content_type="application/x-npy", method="POST"):
    req = urllib.request.Request(
        url, data=body, method=method,
        headers={"Content-Type": content_type} if body is not None else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _patch_probs(model, img, lanes=8):
    """softmax of the model on ``img`` in lane 0 of a zero-padded batch of
    ``lanes``, as the engine's patch forward runs it."""
    x = np.zeros((lanes, *img.shape), np.uint8)
    x[0] = img
    with torch.no_grad():
        logits = model(torch.from_numpy(x).float() / 255.0)
    return torch.softmax(logits.float(), -1)[0].numpy()


# --------------------------------------------------------------------------
# engine-level parity


def test_fcn_mode_matches_direct_call(engine, model, image):
    amap, meta = engine.predict_slide(image, mode="fcn")
    ref, _ = predict_full_fcn(image, model, NC, patch_size=PS, device="cpu", **FCN)
    np.testing.assert_array_equal(amap, ref)
    assert amap.dtype == np.uint8
    assert meta["mode"] == "fcn" and meta["h"] == H and meta["w"] == W
    assert meta["streamed"] is False


def test_dense_mode_matches_direct_call(engine, model, image):
    amap, meta = engine.predict_slide(image, mode="dense")
    ref, _ = predict_full_fused(image, model, NC, patch_size=PS, device="cpu")
    np.testing.assert_array_equal(amap, ref)
    assert meta["mode"] == "dense"


def test_random_mode_matches_direct_call(engine, model, image):
    amap, meta = engine.predict_slide(image, mode="random", seed=3)
    batch = min(512, (H // 16) * (W // 16))
    ref = predict_full_random_fused(image, model, NC, patch_size=PS, batch_size=batch, seed=3,
                                    device="cpu")[0]
    np.testing.assert_array_equal(amap, ref)
    assert amap.shape == tuple(meta["map_shape"])


def test_patch_predict_matches_model(engine, model):
    img = np.random.default_rng(3).integers(0, 255, (PS, PS, 3), dtype=np.uint8)
    out = engine.predict_patch(img)
    want = _patch_probs(model, img)
    assert out["class"] == int(want.argmax())
    np.testing.assert_allclose(out["probs"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sum(out["probs"]), 1.0, atol=1e-3)


def test_patch_resizes_arbitrary_input(engine, model):
    """A patch of another size is resized with Pillow's bilinear filter
    (``_resize_uint8``, the same bytes as Pillow's ``Image.resize``)."""
    img = np.random.default_rng(4).integers(0, 255, (100, 80, 3), dtype=np.uint8)
    out = engine.predict_patch(img)
    resized = _resize_uint8(img, (PS, PS))
    assert out == engine.predict_patch(resized)
    pil = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(
        resized, np.asarray(pil.fromarray(img).resize((PS, PS), pil.BILINEAR)))


def test_staged_slide_matches_unstaged(engine, image):
    engine.stage_slide("s1", image)
    assert engine._staged["s1"].tiles is not None  # pre-tiled under the cut-off
    amap_staged, _ = engine.predict_slide(key="s1", mode="fcn")
    amap, _ = engine.predict_slide(image, mode="fcn")
    np.testing.assert_array_equal(amap_staged, amap)


def test_giant_slide_stages_untiled(engine, image, monkeypatch):
    """Above ``PRE_TILE_MAX_PIXELS`` the engine stages untiled: the same map."""
    monkeypatch.setattr(eng_mod, "PRE_TILE_MAX_PIXELS", 1)
    engine.stage_slide("giant", image)
    st = engine._staged["giant"]
    assert st.tiles is None and st.packed is not None
    amap_staged, _ = engine.predict_slide(key="giant", mode="fcn")
    amap, _ = engine.predict_slide(image, mode="fcn")
    np.testing.assert_array_equal(amap_staged, amap)


def test_stage_lru_evicts(model, image):
    eng = ServingEngine(model, CFG, max_staged_slides=2, device="cpu", **FCN)
    for k in ("a", "b", "c"):
        eng.stage_slide(k, image)
    assert list(eng.info()["staged_slides"]) == ["b", "c"]
    with pytest.raises(KeyError):
        eng.predict_slide(key="a", mode="fcn")
    eng.predict_slide(key="b", mode="fcn")  # b is now the most recent
    eng.stage_slide("d", image)
    assert list(eng.info()["staged_slides"]) == ["b", "d"]
    assert eng.evict_slide("b") and not eng.evict_slide("b")


def test_input_validation(engine, image):
    with pytest.raises(ValueError):
        engine.predict_slide(image, mode="nope")
    with pytest.raises(ValueError):
        engine.predict_slide()  # neither image nor key
    with pytest.raises(ValueError):
        engine.predict_slide(image.astype(np.float32))  # not uint8
    with pytest.raises(ValueError):
        engine.predict_slide(image, key="s1")  # both
    with pytest.raises(ValueError, match="fcn mode only"):
        engine.predict_slide(key="s1", mode="dense")
    with pytest.raises(ValueError):
        engine.predict_patch(np.zeros((PS, PS), np.uint8))
    with pytest.raises(ValueError, match="mode must be"):
        ServingEngine(narrow_resnet("s2d")[2], CFG, mode="nope", device="cpu")
    if not torch.cuda.is_available():  # the card, unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(narrow_resnet("s2d")[2], CFG)


# --------------------------------------------------------------------------
# HTTP wire contract


def test_http_healthz_and_model(http):
    st, _, body = _post(http + "/healthz", None, method="GET")
    health = json.loads(body)
    assert st == 200 and health["ok"] is True
    assert health["device"] == "cpu" and health["device_name"] == "cpu"
    st, _, body = _post(http + "/v1/model", None, method="GET")
    info = json.loads(body)
    assert st == 200
    assert info["n_classes"] == NC and info["patch_size"] == PS
    assert info["default_mode"] == "fcn" and info["modes"] == ["fcn", "dense", "random"]


def test_http_patch_roundtrip(http, engine):
    img = np.random.default_rng(3).integers(0, 255, (PS, PS, 3), dtype=np.uint8)
    st, _, body = _post(http + "/v1/patch", _npy(img))
    assert st == 200
    assert json.loads(body) == engine.predict_patch(img)


def test_http_patch_accepts_png(http, engine):
    """PNG bodies, from the port's encoder and from Pillow's, decode to the
    array; a JPEG body is decoded by Pillow."""
    img = np.random.default_rng(5).integers(0, 255, (PS, PS, 3), dtype=np.uint8)
    st, _, body = _post(http + "/v1/patch", encode_png(img), "image/png")
    assert st == 200 and json.loads(body) == engine.predict_patch(img)
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="PNG")
    st, _, body = _post(http + "/v1/patch", buf.getvalue(), "image/png")
    assert st == 200 and json.loads(body) == engine.predict_patch(img)
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG")
    jpeg = np.asarray(pil.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    st, _, body = _post(http + "/v1/patch", buf.getvalue(), "image/jpeg")
    assert st == 200 and json.loads(body) == engine.predict_patch(jpeg)


def test_http_slide_npy_roundtrip(http, model, image):
    for mode in ("fcn", "dense"):
        st, headers, body = _post(http + f"/v1/slide?mode={mode}", _npy(image))
        assert st == 200
        assert headers["Content-Type"] == "application/x-npy"
        meta = json.loads(headers["X-DeepHisto-Meta"])
        amap = np.load(io.BytesIO(body))
        if mode == "fcn":
            ref, _ = predict_full_fcn(image, model, NC, patch_size=PS, device="cpu", **FCN)
        else:
            ref, _ = predict_full_fused(image, model, NC, patch_size=PS, device="cpu")
        np.testing.assert_array_equal(amap, ref)
        assert meta["h"] == H and meta["w"] == W and meta["mode"] == mode


def test_http_slide_json_format(http, engine, image):
    st, _, body = _post(http + "/v1/slide?mode=fcn&format=json", _npy(image))
    out = json.loads(body)
    assert st == 200
    amap = np.asarray(out["class_map"])
    assert amap.shape == tuple(out["meta"]["map_shape"])
    np.testing.assert_array_equal(amap, engine.predict_slide(image, mode="fcn")[0])


def test_http_stage_then_predict_by_key(http, engine, image):
    st, _, body = _post(http + "/v1/stage?key=ws1", _npy(image))
    assert st == 200 and "ws1" in json.loads(body)["staged"]
    st, headers, body = _post(http + "/v1/slide?key=ws1", b"")
    assert st == 200
    amap_direct, _ = engine.predict_slide(image, mode="fcn")
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), amap_direct)
    st, _, body = _post(http + "/v1/stage/ws1", None, method="DELETE")
    assert st == 200 and json.loads(body)["evicted"] == "ws1"
    st, _, _ = _post(http + "/v1/stage/ws1", None, method="DELETE")
    assert st == 404


def test_http_slide_and_stage_from_path(http, engine, image, tmp_path):
    from deephisto_tpu_torch.slide.dhs import write_dhs

    path = tmp_path / "slide.dhs"
    write_dhs(image, path, max_layer=2)
    req = json.dumps({"path": str(path), "layer": 1}).encode()
    st, _, body = _post(http + "/v1/slide?mode=fcn", req, "application/json")
    assert st == 200
    amap_direct, _ = engine.predict_slide(image, mode="fcn")
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), amap_direct)
    req = json.dumps({"path": str(path), "layer": 1, "key": "from_path"}).encode()
    st, _, body = _post(http + "/v1/stage", req, "application/json")
    assert st == 200 and "from_path" in json.loads(body)["staged"]
    st, _, body = _post(http + "/v1/slide?key=from_path", b"")
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), amap_direct)
    assert engine.evict_slide("from_path")


def test_http_warmup(http):
    st, _, body = _post(http + "/v1/warmup?h=96&w=128&mode=dense", b"")
    meta = json.loads(body)
    assert st == 200 and meta["warmup"] is True and meta["map_shape"] == [6, 8]


def test_http_errors(http):
    st, _, body = _post(http + "/v1/nope", b"")
    assert st == 404
    st, _, body = _post(http + "/v1/nope", None, method="GET")
    assert st == 404
    st, _, body = _post(http + "/v1/patch", b"garbage")
    assert st == 400 and "npy" in json.loads(body)["error"]
    st, _, body = _post(http + "/v1/patch", b"\x89PNG\r\n\x1a\nbroken", "image/png")
    assert st in (400, 500)
    st, _, body = _post(http + "/v1/slide?key=missing", b"")
    assert st == 400
    st, _, body = _post(http + "/v1/slide", json.dumps({}).encode(), "application/json")
    assert st == 400 and "path" in json.loads(body)["error"]
    st, _, body = _post(http + "/v1/stage", _npy(np.zeros((4, 4, 3), np.uint8)))
    assert st == 400  # a binary stage without ?key=


# --------------------------------------------------------------------------
# checkpoint loading, and the two packages' daemons on one checkpoint


def _r18_checkpoint(tmp_path):
    """A factory-built s2d ResNet-18's random variables (every BN statistic
    random) saved by the JAX package's ``save_model`` as flax msgpack, and
    the config YAML naming it."""
    from deephisto_tpu.models.patch_cls_simple.model import get_model as jax_get_model
    from deephisto_tpu.train.checkpoint import save_model as jax_save_model

    real = jax_get_model(NC, depth=18, stem="s2d")
    shapes = jax.eval_shape(real.init, jax.random.key(1), jnp.zeros((1, PS, PS, 3)))
    v = _random_variables(shapes, np.random.default_rng(1))
    ckpt = tmp_path / "best_model.msgpack"
    jax_save_model(ckpt, v["params"], v["batch_stats"])
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(
        f"model:\n  n_classes: {NC}\n  depth: 18\n  stem: s2d\ndataset:\n  patch_size: {PS}\n")
    return real, v, ckpt, cfg_path


def test_from_checkpoint(tmp_path):
    from deephisto_tpu_torch.models.patch_cls_simple import get_model
    from deephisto_tpu_torch.train.checkpoint import load_model, load_variables, save_model

    real, v, ckpt, cfg_path = _r18_checkpoint(tmp_path)
    # the port's own save_model writes the same file back
    port = load_variables(get_model(NC, depth=18, stem="s2d"), load_model(ckpt))
    save_model(tmp_path / "port.msgpack", port)
    assert (tmp_path / "port.msgpack").read_bytes() == ckpt.read_bytes()
    eng = ServingEngine.from_checkpoint(cfg_path, tmp_path / "port.msgpack", device="cpu",
                                        **FCN)
    try:
        img = np.random.default_rng(9).integers(0, 255, (PS, PS, 3), dtype=np.uint8)
        out = eng.predict_patch(img)
        assert out["probs"] == [float(p) for p in _patch_probs(port.eval(), img)]
        ref = real.apply(v, jnp.asarray(img[None]).astype(jnp.float32) / 255.0, train=False)
        assert out["class"] == int(jnp.argmax(ref, -1)[0])
    finally:
        eng.close()


def test_from_checkpoint_orbax_dir_raises(tmp_path):
    """A directory is read as the port's own train-state checkpoint
    (``train/dist_ckpt.py``, tests/test_torch_dist_ckpt.py serves one); the
    JAX package's orbax directory holds no step of that format and raises."""
    from deephisto_tpu.train import create_train_state as jax_create_train_state
    from deephisto_tpu.train import orbax_ckpt as oc

    real, v, _, cfg_path = _r18_checkpoint(tmp_path)
    mgr = oc.checkpoint_manager(tmp_path / "orbax", async_save=False)
    oc.save_train_state(mgr, 5, jax_create_train_state(real, v, learning_rate=1e-3), epoch=2)
    mgr.close()
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        ServingEngine.from_checkpoint(cfg_path, tmp_path / "orbax", device="cpu")


def test_two_packages_serve_equal_maps_from_one_checkpoint(tmp_path, image):
    """The JAX package's daemon and the port's, each built by
    ``from_checkpoint`` from one flax msgpack checkpoint, answer
    ``/v1/slide`` in fcn and dense mode with equal maps. Both serve the bf16
    ResNet-18; a cell where the JAX package's own two top scores are within
    1e-2 of each other (bf16 convs summed in other orders) is not held,
    and there are none on this slide."""
    from deephisto_tpu.predict.fcn import predict_full_fcn as jax_fcn
    from deephisto_tpu.serve import ServingEngine as JaxEngine
    from deephisto_tpu.serve.server import serve_in_thread as jax_serve

    _, v, ckpt, cfg_path = _r18_checkpoint(tmp_path)
    jeng = JaxEngine.from_checkpoint(cfg_path, ckpt, **FCN)
    teng = ServingEngine.from_checkpoint(cfg_path, ckpt, device="cpu", **FCN)
    jsrv, jbase = jax_serve(jeng)
    tsrv, tbase = _serve(teng)
    try:
        for mode in ("fcn", "dense"):
            st_j, _, body_j = _post(jbase + f"/v1/slide?mode={mode}", _npy(image))
            st_t, _, body_t = _post(tbase + f"/v1/slide?mode={mode}", _npy(image))
            assert st_j == st_t == 200
            want, got = np.load(io.BytesIO(body_j)), np.load(io.BytesIO(body_t))
            if mode == "fcn":
                _, score = jax_fcn(image, jeng.model, jeng.variables, NC, patch_size=PS, **FCN)
                top2 = np.sort(np.asarray(score, np.float32), axis=-1)[..., -2:]
                assert ((top2[..., 1] - top2[..., 0]) > 1e-2).all()
            np.testing.assert_array_equal(got, want)
    finally:
        _stop(jsrv)
        _stop(tsrv)


def test_cli_builds_the_engine_and_serves(tmp_path, monkeypatch):
    from deephisto_tpu_torch.serve import __main__ as cli

    _, _, ckpt, cfg_path = _r18_checkpoint(tmp_path)
    served = {}

    def fake_serve(engine, host, port, verbose=False):
        served.update(engine=engine, host=host, port=port, verbose=verbose)

    monkeypatch.setattr(cli, "serve_forever", fake_serve)
    cli.main(["--config", str(cfg_path), "--weights", str(ckpt), "--mode", "dense",
              "--tile", "64", "--halo", "32", "--tile-batch", "2", "--warm", "96x96",
              "--device", "cpu", "--port", "0", "-v"])
    eng = served["engine"]
    try:
        assert eng.default_mode == "dense" and eng.info()["requests"] == 2
        assert (eng.tile, eng.halo, eng.tile_batch) == (64, 32, 2)
        assert served["verbose"] is True and served["port"] == 0
    finally:
        eng.close()


# --------------------------------------------------------------------------
# patch coalescing


def test_patch_request_coalescing(model):
    """Concurrent predict_patch calls coalesce into few LANES-wide forwards
    and return exactly the sequential answers."""
    eng = ServingEngine(model, CFG, patch_lanes=8, patch_wait_ms=50.0, device="cpu", **FCN)
    try:
        rng = np.random.default_rng(3)
        imgs = [rng.integers(0, 255, (PS, PS, 3), dtype=np.uint8) for _ in range(16)]
        sequential = [eng.predict_patch(im) for im in imgs]  # builds the batcher

        dispatches = []
        inner = eng._patch_batcher._run

        def counting(batch):
            dispatches.append(len(batch))
            return inner(batch)

        eng._patch_batcher._run = counting
        results = [None] * len(imgs)
        barrier = threading.Barrier(len(imgs))

        def worker(i):
            barrier.wait()
            results[i] = eng.predict_patch(imgs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == sequential
        assert sum(dispatches) == 16
        assert len(dispatches) <= 4, f"16 concurrent requests took {dispatches}"
        assert max(dispatches) <= 8
    finally:
        eng.close()
    assert eng._patch_batcher is None


def test_patch_batcher_surfaces_errors():
    """A failing batch raises in every waiting request, and the thread
    serves the next one."""
    calls = []

    def run(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return np.ones((len(batch), 2), np.float32)

    b = _PatchBatcher(run, lanes=4, wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(np.zeros((4, 4, 3), np.uint8))
        out = b.submit(np.zeros((4, 4, 3), np.uint8))
        assert out.shape == (2,)
    finally:
        b.close()
    assert not b._thread.is_alive()


# --------------------------------------------------------------------------
# int8 serving and the ViT fallback


@pytest.fixture(scope="module")
def calib():
    return np.random.default_rng(0).integers(0, 255, (8, PS, PS, 3), dtype=np.uint8)


def test_load_calib():
    u8 = np.random.default_rng(0).integers(0, 255, (70, 8, 8, 3), dtype=np.uint8)
    batches = _load_calib(u8)
    assert [len(b) for b in batches] == [64, 6] and batches[0].dtype == np.float32
    np.testing.assert_array_equal(np.concatenate(batches), u8.astype(np.float32) / 255.0)
    noise = _load_calib(None)
    assert noise[0].shape == (64, 224, 224, 3)


def test_int8_engine_fcn_pack8(model, image, calib):
    eng = ServingEngine(model, CFG, int8=True, calib=calib, device="cpu", **FCN)
    assert eng.info()["int8"] is True
    assert isinstance(eng.qmodel_fcn, QuantizedResNet) and eng.qmodel_fcn.pack_l1 is True
    assert eng.qmodel.pack_l1 is False
    amap, meta = eng.predict_slide(image, mode="fcn")
    assert meta["int8"] is True
    ref, _ = predict_full_fcn(image, eng.qmodel_fcn, NC, patch_size=PS, device="cpu", **FCN)
    np.testing.assert_array_equal(amap, ref)
    amap2, _ = eng.predict_slide(image, mode="dense")
    ref2, _ = predict_full_fused(image, eng.qmodel, NC, patch_size=PS, device="cpu")
    np.testing.assert_array_equal(amap2, ref2)
    eng.stage_slide("p8", image)  # the pack_l1 model takes the pack=8 staging
    assert eng._staged["p8"].pack == 8
    amap_staged, _ = eng.predict_slide(key="p8", mode="fcn")
    np.testing.assert_array_equal(amap_staged, amap)


def test_int8_engine_bottleneck_skips_pack_l1(image, calib):
    """A Bottleneck ResNet has no packed stage 1: the int8 engine serves fcn
    unpacked and stages at pack 4."""
    m = ResNet((1, 1, 1, 1), Bottleneck, NC, num_filters=8, dtype=torch.float32, stem="s2d")
    eng = ServingEngine(m, CFG, int8=True, calib=calib, device="cpu", **FCN)
    assert eng.qmodel_fcn.pack_l1 is False
    eng.stage_slide("b", image)
    assert eng._staged["b"].pack == 4
    amap_staged, _ = eng.predict_slide(key="b", mode="fcn")
    amap, meta = eng.predict_slide(image, mode="fcn")
    assert meta["int8"] is True
    np.testing.assert_array_equal(amap_staged, amap)


def test_stage_requires_s2d_stem(image):
    m = narrow_resnet("imagenet")[2]
    icfg = {"model": {"n_classes": NC, "depth": 18, "stem": "imagenet"},
            "dataset": {"patch_size": PS}}
    eng = ServingEngine(m, icfg, device="cpu", **FCN)
    with pytest.raises(ValueError, match="s2d"):
        eng.stage_slide("k", image)
    amap, _ = eng.predict_slide(image, mode="fcn")  # the unstaged path serves
    ref, _ = predict_full_fcn(image, m, NC, patch_size=PS, device="cpu", **FCN)
    np.testing.assert_array_equal(amap, ref)


@pytest.mark.parametrize("int8", [False, True])
def test_vit_engine_falls_back_to_dense(image, int8):
    m = ViT(NC, patch=16, dim=32, depth=1, heads=2, img_size=PS)
    vcfg = {"model": {"n_classes": NC, "arch": "vit"}, "dataset": {"patch_size": PS}}
    eng = ServingEngine(m, vcfg, mode="fcn", int8=int8, device="cpu")
    try:
        assert eng.default_mode == "dense"  # fcn needs a conv feature map
        assert "fcn" not in eng.info()["modes"]
        with pytest.raises(ValueError):
            eng.predict_slide(image, mode="fcn")
        amap, meta = eng.predict_slide(image, mode="dense")
        assert amap.dtype == np.uint8 and meta["mode"] == "dense"
        want = eng.qmodel if int8 else m
        np.testing.assert_array_equal(
            amap, predict_full_fused(image, want, NC, patch_size=PS, device="cpu")[0])
        with pytest.raises(ValueError):
            eng.stage_slide("k", image)
        out = eng.predict_patch(image[:PS, :PS])
        assert len(out["probs"]) == NC
    finally:
        eng.close()


def test_over_budget_routes_to_streamed(model, image):
    eng = ServingEngine(model, CFG, stream_above_bytes=1, device="cpu", **FCN)
    amap_s, meta = eng.predict_slide(image, mode="fcn")
    assert meta["streamed"] is True
    ref, _ = predict_full_fcn_streamed(image, model, NC, patch_size=PS, device="cpu", **FCN)
    np.testing.assert_array_equal(amap_s, ref)
    resident = ServingEngine(model, CFG, device="cpu", **FCN)
    amap_r, meta_r = resident.predict_slide(image, mode="fcn")
    assert meta_r["streamed"] is False
    np.testing.assert_array_equal(amap_s, amap_r)
