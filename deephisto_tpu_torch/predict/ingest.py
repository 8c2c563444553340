"""The slide's host→card upload: the slide ingest layer of the predicts.

A slide comes in as a pageable host array. CUDA's own copy from pageable
memory stages it through a small buffer of CUDA's own, on one thread, at about a
seventh of what the card's copy engine takes from pinned memory (6 against
43 GB/s on an H100 host). :func:`upload_slide` instead moves such a slide
through a fixed ring of pinned host buffers (``SLOTS`` of ``SLOT_BYTES``,
one ring per device and process), in chunks of whole rows
(:func:`chunk_plan`): the host copies chunk i+1 into its slot (OpenMP
``memcpy``s over the process's intra-op thread count) while the copy engine
moves chunk i from its own slot to the card, on the current stream. A slot
is written again only once its previous copy to the card has ended, and the
upload returns once the last chunk is on the card. The loop runs in the
native library (``native.stage_upload_native``), in one call that releases
the interpreter lock, and calls libcuda's copy and event functions
itself.

Pinned memory stays at the ring's fixed size whatever the slide's size,
and nothing is kept of the caller's array: each upload pays what a freshly
read slide pays. A source already on the card or already pinned, a source
whose rows are strided inside, an upload to the CPU, and any upload where
the native library cannot be built, go through one plain ``.to(device)``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import numpy as np
import torch

from .. import native
from ..profiling import span

SLOTS = 2  # buffers of the ring
SLOT_BYTES = 16 << 20  # bytes of each
CU_FUNCS = ("cuMemcpyHtoDAsync_v2", "cuEventRecord", "cuEventSynchronize")

_rings: dict[torch.device, _Ring] = {}
_rings_lock = threading.Lock()


def chunk_plan(shape: tuple[int, ...], slot_bytes: int,
               itemsize: int = 1) -> list[tuple[tuple[int, ...], int, int]]:
    """The chunks, in order, of a C-ordered array of ``shape`` (elements
    of ``itemsize`` bytes) for slots of ``slot_bytes``. Each is ``(prefix,
    start, stop)``, the block ``x[prefix][start:stop]``: whole rows of
    axis ``len(prefix)``, as many as fill a slot, the last chunk of an axis
    taking the remainder. Rows of axis 0 are grouped; a row wider than a
    slot is cut within itself, along the next axis, and so on down."""
    if slot_bytes < itemsize:
        raise ValueError(f"a slot of {slot_bytes} bytes holds no element of {itemsize}")

    def plan(prefix: tuple[int, ...], axis: int) -> list:
        row = itemsize * math.prod(shape[axis + 1:])
        if row <= slot_bytes:
            per = slot_bytes // row
            return [(prefix, a, min(a + per, shape[axis])) for a in range(0, shape[axis], per)]
        return [c for i in range(shape[axis]) for c in plan(prefix + (i,), axis + 1)]

    return plan((), 0) if shape else []


def chunk_table(shape: tuple[int, ...], strides: tuple[int, ...], itemsize: int,
                slot_bytes: int) -> np.ndarray:
    """:func:`chunk_plan`'s chunks as the rows the native loop takes, (n, 5)
    int64: source byte offset, rows, row bytes, source row stride, and byte
    offset in the contiguous destination. The source has ``strides`` (in
    elements) and its rows along axis 0 are each contiguous inside."""
    dense = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    out = []
    for prefix, a, b in chunk_plan(shape, slot_bytes, itemsize):
        axis = len(prefix)
        src = itemsize * (sum(i * s for i, s in zip(prefix, strides)) + a * strides[axis])
        dst = itemsize * (sum(i * d for i, d in zip(prefix, dense)) + a * dense[axis])
        row = itemsize * dense[axis]
        if axis == 0 and len(shape) > 1:  # whole rows, strided in the source
            out.append((src, b - a, row, itemsize * strides[0], dst))
        else:  # a run inside one contiguous row
            out.append((src, 1, (b - a) * row, (b - a) * row, dst))
    return np.asarray(out, dtype=np.int64).reshape(-1, 5)


def _libcuda_api() -> tuple[int, int, int]:
    """The addresses of libcuda's functions the native loop calls. libcuda
    is one library per process: its streams and events are the ones torch's
    runtime hands out."""
    lib = ctypes.CDLL("libcuda.so.1")
    return tuple(ctypes.cast(getattr(lib, name), ctypes.c_void_p).value for name in CU_FUNCS)


class _Ring:
    """``slots`` host buffers of ``slot_bytes``, pinned for a card, each
    with an event there that marks the end of its last copy to the card.
    ``api`` holds the addresses of the three functions of ``CU_FUNCS``:
    libcuda's on a card; on the CPU, stand-ins that the tests give
    (with plain buffers and the events 1, 2, …)."""

    def __init__(self, device: torch.device, slots: int = SLOTS, slot_bytes: int = SLOT_BYTES,
                 api: tuple[int, int, int] | None = None):
        cuda = device.type == "cuda"
        self.device, self.slot_bytes = device, slot_bytes
        self.bufs = [torch.empty(slot_bytes, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(slots)]
        if cuda:
            with torch.cuda.device(device):
                self._events = [torch.cuda.Event() for _ in range(slots)]
                for e in self._events:
                    e.record()  # made on the card, so each has a handle
            self.events = [e.cuda_event for e in self._events]
        else:
            self.events = list(range(1, slots + 1))
        self.api = api or _libcuda_api()
        self.lock = threading.Lock()

    def copy(self, src: torch.Tensor, dst: torch.Tensor) -> int:
        """Copy host tensor ``src``, whose rows are each contiguous inside,
        into the contiguous ``dst`` of its shape and dtype through the ring;
        returns the number of chunks."""
        table = chunk_table(tuple(src.shape), src.stride(), src.element_size(), self.slot_bytes)
        cuda = self.device.type == "cuda"
        with self.lock, torch.cuda.device(self.device) if cuda else contextlib.nullcontext():
            stream = 0
            if cuda:
                current = torch.cuda.current_stream()
                current.query()  # a runtime call: the card's context is now this thread's
                stream = current.cuda_stream
            err = native.stage_upload_native(
                dst.data_ptr(), src.data_ptr(), table, [b.data_ptr() for b in self.bufs],
                self.slot_bytes, self.events, stream, torch.get_num_threads(), self.api)
        if err:
            raise RuntimeError(f"the staged upload to {self.device} failed: CUDA error {err}")
        return len(table)


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Each row of ``t`` (its sub-array along axis 0) is contiguous."""
    return t.numel() > 0 and (t[0] if t.dim() > 1 else t).is_contiguous()


def _staging_ring(t: torch.Tensor, device: torch.device) -> _Ring | None:
    """The ring that uploads ``t`` to ``device``: only a pageable host
    tensor going to a card, its rows contiguous inside, takes one."""
    if not (t.device.type == "cpu" and device.type == "cuda" and t.dim() and not t.is_pinned()
            and _rows_contiguous(t) and native.available()):
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _rings_lock:
        if device not in _rings:
            _rings[device] = _Ring(device)
        return _rings[device]


def upload_slide(image, device) -> torch.Tensor:
    """``image`` (an array or a tensor) on ``device``, in the span
    ``ingest.upload`` (attrs ``bytes``, ``pinned`` (the source),
    ``blocking``, and ``staged``: the chunks that went through the ring, 0
    on a direct path). It returns once the data is on ``device``; through
    the ring the result is contiguous."""
    t, device = torch.as_tensor(image), torch.device(device)
    ring = _staging_ring(t, device)
    with span("ingest.upload", bytes=t.nbytes, pinned=t.is_pinned(),
              blocking=t.device.type != device.type, staged=0) as attrs:
        if ring is None:
            return t.to(device)
        dst = torch.empty(t.shape, dtype=t.dtype, device=device)
        attrs["staged"] = ring.copy(t, dst)
        return dst
