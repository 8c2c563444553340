"""Dependency-free HTTP front end for :class:`ServingEngine`, a port of
``deephisto_tpu/serve/server.py``.

stdlib ``http.server`` only. Arrays travel as ``.npy`` bodies
(``application/x-npy``); metadata as JSON (next to a binary payload, in the
``X-DeepHisto-Meta`` header). The engine serializes the card's work, so the
threaded server is safe; requests that only read state never touch the
card.

Routes (status codes as the JAX package's: 200, 400 for a bad request or an
unknown staged key, 404 for an unknown route, 500 for anything else):

    GET    /healthz            liveness, the torch device and the card's name
    GET    /v1/model           the engine's ``info()``
    POST   /v1/patch           one patch (npy, PNG or another image/* body) → class, probs
    POST   /v1/slide           class map: npy body, or JSON {path, layer}, or
                               ?key= of a staged slide; ?mode=, ?format=json
    POST   /v1/stage           stage a slide: npy body with ?key=, or JSON {path, layer, key}
    DELETE /v1/stage/<key>     evict a staged slide
    POST   /v1/warmup          ?h=&w=&mode=: run a slide of that size first
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .._imageio import SIGNATURE as PNG_SIGNATURE
from .._imageio import decode_png
from .engine import ServingEngine


def _read_slide_layer(path: str, layer: int) -> np.ndarray:
    from ..slide import open_slide

    with open_slide(path) as slide:
        h, w = slide.layer_size(layer)  # coords are (y, x), slide/base.py
        return np.asarray(slide.get_region_from_layer(layer, (0, 0), (h, w)))


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _decode_array(body: bytes, content_type: str) -> np.ndarray:
    """An npy body, or an image/* body: PNG by the port's codec, any other
    image type by Pillow where it imports."""
    if content_type.startswith("image/"):
        if body.startswith(PNG_SIGNATURE):
            return decode_png(body)
        try:
            from PIL import Image
        except ImportError as e:
            raise ValueError(f"{content_type} bodies need Pillow, which is not "
                             "installed; send PNG or .npy") from e
        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    # default: .npy; the magic check catches a mislabeled body early
    if not body.startswith(b"\x93NUMPY"):
        raise ValueError(
            "body is neither .npy (magic missing) nor image/*; send the "
            "array via np.save or set an image/* content-type"
        )
    return np.load(io.BytesIO(body), allow_pickle=False)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine  # set by make_server
    protocol_version = "HTTP/1.1"

    # ----- plumbing ----------------------------------------------------
    def log_message(self, fmt, *args):  # quiet unless the server is verbose
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: bytes, content_type: str, meta: dict | None = None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        if meta is not None:
            self.send_header("X-DeepHisto-Meta", json.dumps(meta))
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _error(self, code: int, msg: str):
        self._json(code, {"error": msg})

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""

    def _query(self) -> dict[str, str]:
        q = parse_qs(urlparse(self.path).query)
        return {k: v[-1] for k, v in q.items()}

    # ----- routes ------------------------------------------------------
    def do_GET(self):
        route = urlparse(self.path).path
        if route == "/healthz":
            dev = self.engine.device
            self._json(200, {
                "ok": True,
                "device": str(dev),
                "device_name": _device_name(dev),
                "requests": self.engine.info()["requests"],
            })
        elif route == "/v1/model":
            self._json(200, self.engine.info())
        else:
            self._error(404, f"no route {route}")

    def do_DELETE(self):
        route = urlparse(self.path).path
        if route.startswith("/v1/stage/"):
            key = route[len("/v1/stage/"):]
            if self.engine.evict_slide(key):
                self._json(200, {"evicted": key})
            else:
                self._error(404, f"no staged slide {key!r}")
        else:
            self._error(404, f"no route {route}")

    def do_POST(self):
        route = urlparse(self.path).path
        try:
            if route == "/v1/patch":
                self._post_patch()
            elif route == "/v1/slide":
                self._post_slide()
            elif route == "/v1/stage":
                self._post_stage()
            elif route == "/v1/warmup":
                self._post_warmup()
            else:
                self._error(404, f"no route {route}")
        except (ValueError, KeyError) as e:
            self._error(400, str(e))
        except Exception as e:  # noqa: BLE001 — the daemon must not die on a request
            self._error(500, f"{type(e).__name__}: {e}")

    def _slide_input(self) -> np.ndarray:
        """Slide pixels from the request: a binary body, or JSON {path, layer}."""
        ctype = self.headers.get("Content-Type", "application/x-npy")
        body = self._body()
        if ctype.startswith("application/json"):
            req = json.loads(body or b"{}")
            if "path" not in req:
                raise ValueError("JSON slide requests need a 'path'")
            return _read_slide_layer(req["path"], int(req.get("layer", 2)))
        return _decode_array(body, ctype)

    def _post_patch(self):
        img = _decode_array(self._body(), self.headers.get("Content-Type", "application/x-npy"))
        self._json(200, self.engine.predict_patch(img))

    def _post_slide(self):
        q = self._query()
        mode = q.get("mode")
        key = q.get("key")
        if key is not None:
            self._body()  # drain an empty or ignored body: the connection stays usable
            amap, meta = self.engine.predict_slide(key=key, mode=mode or "fcn")
        else:
            amap, meta = self.engine.predict_slide(self._slide_input(), mode=mode)
        if q.get("format") == "json":
            self._json(200, {"meta": meta, "class_map": amap.tolist()})
        else:
            self._send(200, _npy_bytes(amap), "application/x-npy", meta=meta)

    def _post_stage(self):
        q = self._query()
        ctype = self.headers.get("Content-Type", "application/x-npy")
        if ctype.startswith("application/json"):
            req = json.loads(self._body() or b"{}")
            key = req.get("key") or q.get("key")
            if "path" not in req:
                raise ValueError("JSON stage requests need a 'path'")
            key = key or req["path"]
            img = _read_slide_layer(req["path"], int(req.get("layer", 2)))
        else:
            key = q.get("key")
            body = self._body()
            if not key:
                raise ValueError("binary stage requests need ?key=<name>")
            img = _decode_array(body, ctype)
        self._json(200, self.engine.stage_slide(key, img))

    def _post_warmup(self):
        self._body()
        q = self._query()
        h, w = int(q.get("h", 4096)), int(q.get("w", 4096))
        self._json(200, self.engine.warmup(h, w, mode=q.get("mode")))


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: a burst of concurrent
    # clients (the patch-coalescing traffic) would stall in SYN retries
    # before the batcher sees the requests
    request_queue_size = 128
    daemon_threads = True


def make_server(engine: ServingEngine, host: str = "127.0.0.1", port: int = 8477,
                verbose: bool = False) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"engine": engine})
    srv = _Server((host, port), handler)
    srv.verbose = verbose
    return srv


def serve_forever(engine: ServingEngine, host: str = "127.0.0.1", port: int = 8477,
                  verbose: bool = False):
    srv = make_server(engine, host, port, verbose=verbose)
    print(f"deephisto_tpu_torch serving on http://{host}:{srv.server_address[1]}  "
          f"(mode={engine.default_mode}, int8={engine.int8}, device={engine.device})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
    return srv


def serve_in_thread(engine: ServingEngine, host: str = "127.0.0.1", port: int = 0):
    """Start the server on a daemon thread; returns (server, base_url).
    port=0 picks a free port. Stop it with ``server.shutdown()`` and
    ``server.server_close()``."""
    srv = make_server(engine, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True, name="deephisto-http")
    t.start()
    return srv, f"http://{host}:{srv.server_address[1]}"
