"""Native (C++/OpenMP) host helpers, a port of ``deephisto_tpu/native``.

``src/native.cpp`` is the port's own copy of the JAX package's source,
with one function of the port's own (``stage_upload``, the slide ingest's
upload through its pinned ring). It is compiled with ``g++ -O3 -fopenmp
-shared -fPIC`` at the first call that needs it, never at import, into
``build/deephisto_tpu_torch/`` at the repository root (beside the CUDA
kernels of ``_build.py``). The library's
file name carries a hash of the source and the flags, and it is written
under a temporary name and moved into place with ``os.replace``, so a
concurrent build never loads a partial file and an edited source is never
loaded stale.

These are host helpers, not card kernels. Where ``g++`` or OpenMP is
missing, :func:`available` is False and the callers
(``geometry/polygon.py:clip_area_boxes``, the host modes of
``samplers/bank.py`` and ``samplers/full.py``) take numpy, as in the JAX
package; ``predict/ingest.py`` takes the plain ``.to(device)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "src" / "native.cpp"
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
build_log = ""


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdeephisto_native-{digest}.so"


def _build(out: Path) -> bool:
    global build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = str(e)
        tmp.unlink(missing_ok=True)
        return False
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load() -> ctypes.CDLL | None:
    """The loaded library, built on the first call; None where it cannot be
    built or loaded (the answer is kept for the process)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            global build_log
            build_log = str(e)
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.clip_area_boxes.argtypes = [p, i64, p, i64, p]
        lib.polygon_areas.argtypes = [p, i64, i64, p]
        lib.extract_patches.argtypes = [p, i64, i64, p, i64, ctypes.c_int32, p]
        i32 = ctypes.c_int32
        lib.stage_upload.argtypes = [ctypes.c_uint64, p, p, i64, p, p, i32, p, i32, p, p, p]
        lib.stage_upload.restype = ctypes.c_int
        lib.native_version.restype = ctypes.c_int
        lib.omp_thread_count.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built (building it on the first call)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library could not be built from {SOURCE}:\n{build_log}")
    return lib


def clip_area_boxes_native(vertices: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Exact polygon∩box areas, C++/OpenMP. Same contract as
    ``geometry.polygon.clip_area_boxes``."""
    lib = _require()
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    b = np.ascontiguousarray(boxes, dtype=np.float64)
    out = np.empty((len(b),), dtype=np.float64)
    lib.clip_area_boxes(v.ctypes.data, len(v), b.ctypes.data, len(b), out.ctypes.data)
    return out


def polygon_areas_native(padded_verts: np.ndarray) -> np.ndarray:
    """Shoelace areas (P,) of a padded (P, V, 2) polygon stack."""
    lib = _require()
    v = np.ascontiguousarray(padded_verts, dtype=np.float64)
    n, nv = v.shape[0], v.shape[1]
    out = np.empty((n,), dtype=np.float64)
    lib.polygon_areas(v.ctypes.data, n, nv, out.ctypes.data)
    return out


def extract_patches_native(
    image: np.ndarray, coords: np.ndarray, patch_size: int, out: np.ndarray | None = None
) -> np.ndarray:
    """Parallel host patch extraction from an HWC uint8 layer (memory-mapped
    arrays too): (N, ps, ps, 3) uint8 at (N, 2) (y, x) corners, each clamped
    into the layer as the device gather clamps it. ``out``, a C-contiguous
    uint8 array of that shape, receives the patches when given."""
    lib = _require()
    img = image if image.flags["C_CONTIGUOUS"] else np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3) uint8, got {img.shape} {img.dtype}")
    if img.shape[0] < patch_size or img.shape[1] < patch_size:
        raise ValueError(
            f"layer {img.shape[:2]} smaller than patch_size {patch_size}; the "
            "native extractor cannot read past the mapping"
        )
    # clamp a fresh copy: an out-of-range corner would make the C++ memcpy
    # read outside the mapping (garbage, or SIGSEGV on a memory-mapped layer)
    c = np.array(coords, dtype=np.int32, copy=True).reshape(-1, 2)
    np.clip(c[:, 0], 0, img.shape[0] - patch_size, out=c[:, 0])
    np.clip(c[:, 1], 0, img.shape[1] - patch_size, out=c[:, 1])
    shape = (len(c), patch_size, patch_size, 3)
    if out is None:
        out = np.empty(shape, dtype=np.uint8)
    elif out.shape != shape or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous {shape} uint8 array")
    lib.extract_patches(img.ctypes.data, img.shape[0], img.shape[1], c.ctypes.data, len(c),
                        patch_size, out.ctypes.data)
    return out


def stage_upload_native(dst: int, src: int, table: np.ndarray, slots: list[int], slot_bytes: int,
                        events: list[int], stream: int, threads: int,
                        api: tuple[int, int, int]) -> int:
    """Upload the chunks of ``table`` ((n, 5) int64 rows: source byte
    offset from ``src``, rows, row bytes, source row stride, destination
    byte offset from ``dst``) through the pinned ``slots`` (addresses, each
    of ``slot_bytes``), each slot's copy to the card followed by its event
    (``events``, raw handles) on ``stream``, the host copies over
    ``threads`` OpenMP threads. ``api`` holds the addresses of libcuda's
    ``cuMemcpyHtoDAsync_v2``, ``cuEventRecord`` and ``cuEventSynchronize``
    (or stand-ins of their signatures). Returns once
    every chunk is on the card: 0, or the first error code. The caller
    vouches for the extent of ``src`` and ``dst``."""
    lib = _require()
    t = np.ascontiguousarray(table, dtype=np.int64).reshape(-1, 5)
    if not slots or len(events) != len(slots) or threads < 1:
        raise ValueError(f"{len(slots)} slots, {len(events)} events, {threads} threads")
    if (t < 0).any() or (t[:, 1] * t[:, 2] > slot_bytes).any():
        raise ValueError(f"a chunk of the table does not fit a slot of {slot_bytes} bytes")
    n = len(slots)
    return lib.stage_upload(dst, src, t.ctypes.data, len(t), (ctypes.c_void_p * n)(*slots),
                            (ctypes.c_void_p * n)(*events), n, stream, threads, *api)


def omp_threads() -> int:
    return _lib.omp_thread_count() if available() else 1
