"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/deephisto_tpu_torch/``
(at the repository root) the first time a kernel of it is launched, and
loaded with ``ctypes``. The library's file name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and never loaded stale. Every C
entry point returns ``cudaGetLastError()``; :func:`check` raises on anything
but 0. A failed build or launch raises: there is no fallback.

The sources are read from the package directory and the libraries written
beside the package, so the port runs from a checkout of the repository or an
editable install (``pip install -e .``). A built wheel carries no ``csrc/``.

``launches`` counts, per kernel, the launches since the last
:func:`reset_launches`; each wrapper adds one where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "deephisto_tpu_torch"
SOURCES = ("gather", "stitch", "attention", "attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

launches: dict[str, int] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count_launch(kernel: str) -> None:
    launches[kernel] = launches.get(kernel, 0) + 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    if not source.is_file():
        raise RuntimeError(
            f"kernel source {source} is missing: the port builds its kernels from "
            "a checkout of the repository or an editable install"
        )
    src = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with
    ``argtypes`` set from ``signatures`` and ``restype`` int on each entry."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.dh_error_string.argtypes = [ctypes.c_int]
        lib.dh_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.dh_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
