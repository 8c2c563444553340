"""int8 convolution with its per-output-channel f32 epilogue, and the ResNet
block's epilogue fused into it: kernel K6 (``csrc/conv_int8.cu``).

Port of the inner convs of ``deephisto_tpu/models/quantize.py:
QuantizedResNet.apply`` (``conv_s32`` / ``conv_f32`` / ``conv_to_int8``,
:460-481), which XLA lowered on the TPU: an NHWC s8 × s8 → s32 convolution,
then, per output channel c,

* :func:`conv_f32`: ``y·a[c] + b[c]`` in f32 (``a`` the dequant scale, ``b``
  the folded bias);
* :func:`conv_to_int8`: ``round(relu(y·a[c] + b[c]))`` clipped to ±127, as
  int8 (``a = dequant·inv``, ``b = bias·inv`` with ``inv`` the next layer's
  input scale, both formed in f32 by the caller as the JAX package forms
  them), rounding half to even as ``jnp.round``;
* :func:`conv_int8_block`: the block's epilogue on ``conv_f32``'s value
  (quantize.py:669-684; the s2d stem's relu at :530), which XLA fused into
  the conv on the TPU: ``o = relu(y + r)`` with the residual ``r`` of
  ``res_kind`` "bf16" (the carry), "f32" (the downsample conv's output),
  "int8" (``x8·s_in``) or "none" (no add), then ``out`` "carry" (the bf16
  carry and the next conv's int8 input, quantized from the carry), "int8"
  (``o`` quantized) or "f32" (``o``).

The product and the sum are two f32 roundings, never one fused multiply-add,
and the s32 sum is rounded to f32 to nearest, as XLA converts it. Scales
stay on the card: ``res_scale`` and ``next_inv`` are 0-d f32 tensors that
the kernel reads there.

Layouts: x (N, H, W, Cin) int8 contiguous; w (Cout, KH, KW, Cin) int8
contiguous (the JAX package's HWIO kernel transposed once, when the model
is built); pads ((top, bottom), (left, right)) as XLA's explicit padding;
the outputs and the residual (N, OH, OW, Cout) contiguous.

:func:`conv_design` chooses K6's design per conv, the one place it is
chosen: ``"wgmma"`` (Hopper's warpgroup product on s8 tiles that TMA's
im2col mode copies into swizzled shared memory, a producer warpgroup and two
consumers on a persistent grid) at Cin % 64 == 0, the ``"mma.sync"`` kernel
otherwise (the stems). The kernel refuses a design it has no kernel for.

:func:`conv_int8_ref` and :func:`conv_int8_block_ref` are the plain
versions: ``F.conv2d`` in float64 on the integer values (exact: |y| ≤
127²·K < 2⁵³, where float32 is not, as 127²·4608 > 2²⁴), cast to int32,
then the epilogue as separate torch ops in the source's order. Tensors on
the CPU take them; CUDA tensors launch K6.

So that ``torch.export`` can carry K6 (``export.py``), each output form is
also a registered op: ``deephisto::conv_int8`` (the f32 and int8 modes),
``deephisto::conv_int8_block`` (the block mode's "int8" and "f32" outputs)
and ``deephisto::conv_int8_block_carry`` (its carry pair). The wrappers
enter them only while tracing (``torch.compiler.is_compiling()``), whatever
the tensors' device, so that a CPU export records the same nodes; their
CUDA implementations are the launches, their CPU ones the plain versions.
Eager calls launch directly: the exact int8 predict launches K6 20 times a
batch, and a dispatcher hop on each is a cost it does not need.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = "conv_int8"
# codes of csrc/conv_int8.cu's Design, Mode, Res and Out enums
DESIGNS = {"mma.sync": 1, "wgmma": 2}
MODES = {"f32": 0, "int8": 1, "block": 2}
RES_KINDS = {"none": 0, "bf16": 1, "f32": 2, "int8": 3}
OUT_KINDS = {"carry": 0, "int8": 1, "f32": 2}
_RES_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = {
    "dh_conv_int8": [
        _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,  # conv, a, b
        _I, _I, _P, _I, _P, _P, _I, _P, _P, _P,  # design, mode, res..., outs, stream
    ]
}


def out_extent(n: int, k: int, stride: int, pad: tuple[int, int]) -> int:
    """Output extent of one axis: ``(n + lo + hi - k) // stride + 1``."""
    return (n + pad[0] + pad[1] - k) // stride + 1


def conv_design(cin: int) -> str:
    """K6's design for a conv of ``cin`` input channels: ``"wgmma"`` at Cin
    % 64 == 0 (every conv of a ResNet block and its downsample), else
    ``"mma.sync"`` (the s2d stem's 48, the imagenet stem's 3). The one place
    it is chosen; the launch passes it to the kernel."""
    if cin < 1:
        raise ValueError(f"Cin must be positive, got {cin}")
    return "wgmma" if cin % 64 == 0 else "mma.sync"


def conv_s32_ref(x: torch.Tensor, w: torch.Tensor, stride: int, pads) -> torch.Tensor:
    """The s8 × s8 → s32 convolution, (N, OH, OW, Cout) int32: float64
    ``conv2d`` on the integer values, exact."""
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb))
    y = F.conv2d(xd, w.permute(0, 3, 1, 2).double(), stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_int8_ref(x, w, stride: int, pads, a, b, to_int8: bool) -> torch.Tensor:
    """Plain version of K6's f32 and int8 modes (module docstring)."""
    y = conv_s32_ref(x, w, stride, pads).to(torch.float32)
    y = y * a + b
    if not to_int8:
        return y
    return torch.clamp(torch.round(torch.relu(y)), -127, 127).to(torch.int8)


def quant_to(xf: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``clip(round(f32(xf)·inv), ±127)`` as int8 (quantize.py's
    ``quant_to``)."""
    return torch.clamp(torch.round(xf.float() * inv), -127, 127).to(torch.int8)


def block_epilogue_ref(y, residual, res_kind: str, res_scale, next_inv, out: str):
    """The block epilogue on ``conv_f32``'s value ``y`` as torch ops in the
    source's order (quantize.py:669-684): the plain version of
    :func:`conv_int8_block`'s epilogue."""
    if res_kind == "none":
        o = torch.relu(y)
    else:
        r = residual.float() * res_scale if res_kind == "int8" else residual.float()
        o = torch.relu(y + r)
    if out == "f32":
        return o
    if out == "int8":
        return quant_to(o, next_inv)
    carry = o.to(torch.bfloat16)
    return carry, quant_to(carry, next_inv)


def conv_int8_block_ref(x, w, stride: int, pads, a, b, residual=None, res_kind: str = "none",
                        res_scale=None, next_inv=None, out: str = "carry"):
    """Plain version of :func:`conv_int8_block`: :func:`conv_int8_ref`'s f32
    value, then :func:`block_epilogue_ref`."""
    y = conv_int8_ref(x, w, stride, pads, a, b, to_int8=False)
    return block_epilogue_ref(y, residual, res_kind, res_scale, next_inv, out)


def _check(x, w, stride, pads, a, b) -> tuple[int, int]:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, Cin) int8, got {tuple(x.shape)} {x.dtype}")
    if w.dtype != torch.int8 or w.ndim != 4 or w.shape[3] != x.shape[3]:
        raise ValueError(
            f"w must be (Cout, KH, KW, Cin={x.shape[3]}) int8, got {tuple(w.shape)} {w.dtype}"
        )
    cout = w.shape[0]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (cout,):
            raise ValueError(f"{name} must be ({cout},) float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if stride < 1 or any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"bad stride {stride} or pads {pads}")
    oh = out_extent(x.shape[1], w.shape[1], stride, pads[0])
    ow = out_extent(x.shape[2], w.shape[2], stride, pads[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"a {tuple(w.shape[1:3])} kernel does not fit {tuple(x.shape[1:3])} "
                         f"padded by {pads}")
    return oh, ow


def _check_block(x, oh, ow, cout, residual, res_kind, res_scale, next_inv, out) -> None:
    if res_kind not in RES_KINDS:
        raise ValueError(f"res_kind must be one of {tuple(RES_KINDS)}, got {res_kind!r}")
    if out not in OUT_KINDS:
        raise ValueError(f"out must be one of {tuple(OUT_KINDS)}, got {out!r}")
    if res_kind == "none":
        if residual is not None:
            raise ValueError("res_kind 'none' takes no residual")
    else:
        want = (x.shape[0], oh, ow, cout)
        if residual is None or tuple(residual.shape) != want or \
                residual.dtype != _RES_DTYPES[res_kind]:
            got = None if residual is None else (tuple(residual.shape), residual.dtype)
            raise ValueError(f"a {res_kind!r} residual must be {want} {_RES_DTYPES[res_kind]}, "
                             f"got {got}")
    scalars = (("res_scale", res_scale, res_kind == "int8"), ("next_inv", next_inv, out != "f32"))
    for name, t, needed in scalars:
        scalar = isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.numel() == 1
        if needed and not scalar:
            raise ValueError(f"{name} must be a one-element float32 tensor, got {t!r}")
    for t in (residual, res_scale if res_kind == "int8" else None,
              next_inv if out != "f32" else None):
        if t is not None and t.device != x.device:
            raise ValueError(f"an epilogue input is on {t.device}, x on {x.device}")


def _launch(x, w, stride, pads, a, b, oh, ow, mode, outs, residual=None, res_kind="none",
            res_scale=None, next_inv=None, out="f32") -> None:
    """One K6 launch in ``mode`` ("f32", "int8" or "block") into the
    preallocated ``outs`` (the carry's two, else one)."""
    if x.device.type != "cuda":
        raise ValueError(f"conv_int8 runs on cpu or cuda, not {x.device}")
    n, h, wd, cin = x.shape
    cout, kh, kw, _ = w.shape
    design = conv_design(cin)
    if design == "wgmma":  # its TMA copies need 16-byte aligned bases
        x, w = (t.clone() if t.data_ptr() % 16 else t for t in (x, w))

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load("conv_int8", _SIGNATURE)
    err = lib.dh_conv_int8(
        x.device.index, x.data_ptr(), n, h, wd, cin, w.data_ptr(), cout, kh, kw, stride,
        pads[0][0], pads[1][0], oh, ow, a.data_ptr(), b.data_ptr(), DESIGNS[design],
        MODES[mode], ptr(residual), RES_KINDS[res_kind], ptr(res_scale), ptr(next_inv),
        OUT_KINDS[out], outs[0].data_ptr(), ptr(outs[1] if len(outs) > 1 else None),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, err, KERNEL)
    _build.count_launch(KERNEL)


def _pads(pads):
    return tuple(tuple(int(p) for p in pair) for pair in pads)


def _flat_pads(pads) -> list[int]:
    return [p for pair in pads for p in pair]


def _pair_pads(flat) -> tuple:
    return ((int(flat[0]), int(flat[1])), (int(flat[2]), int(flat[3])))


def _conv_int8_card(x, w, stride, pads, a, b, to_int8, oh, ow) -> torch.Tensor:
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    out = torch.empty((x.shape[0], oh, ow, w.shape[0]), device=x.device,
                      dtype=torch.int8 if to_int8 else torch.float32)
    _launch(x, w, stride, pads, a, b, oh, ow, "int8" if to_int8 else "f32", (out,))
    return out


def _block_outs(x, oh, ow, cout, out):
    shape = (x.shape[0], oh, ow, cout)
    if out == "carry":
        return (x.new_empty(shape, dtype=torch.bfloat16), x.new_empty(shape, dtype=torch.int8))
    return (x.new_empty(shape, dtype=torch.int8 if out == "int8" else torch.float32),)


def _conv_int8_block_card(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                          out, oh, ow):
    x, w, a, b = (t.contiguous() for t in (x, w, a, b))
    residual = None if residual is None else residual.contiguous()
    outs = _block_outs(x, oh, ow, w.shape[0], out)
    _launch(x, w, stride, pads, a, b, oh, ow, "block", outs, residual, res_kind,
            res_scale if res_kind == "int8" else None, next_inv if out != "f32" else None, out)
    return outs if out == "carry" else outs[0]


# -- the registered ops (module docstring) ----------------------------------

@torch.library.custom_op("deephisto::conv_int8", mutates_args=(), device_types="cuda")
def _conv_int8_op(x: torch.Tensor, w: torch.Tensor, stride: int, pads: list[int],
                  a: torch.Tensor, b: torch.Tensor, to_int8: bool) -> torch.Tensor:
    pads = _pair_pads(pads)
    oh, ow = _check(x, w, stride, pads, a, b)
    return _conv_int8_card(x, w, stride, pads, a, b, to_int8, oh, ow)


@_conv_int8_op.register_kernel("cpu")
def _conv_int8_op_cpu(x, w, stride, pads, a, b, to_int8):
    return conv_int8_ref(x, w, stride, _pair_pads(pads), a, b, to_int8)


@_conv_int8_op.register_fake
def _conv_int8_op_fake(x, w, stride, pads, a, b, to_int8):
    oh, ow = _check(x, w, stride, _pair_pads(pads), a, b)
    return x.new_empty((x.shape[0], oh, ow, w.shape[0]),
                       dtype=torch.int8 if to_int8 else torch.float32)


def _block_op_card(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv, out):
    pads = _pair_pads(pads)
    oh, ow = _check(x, w, stride, pads, a, b)
    return _conv_int8_block_card(x, w, stride, pads, a, b, residual, res_kind, res_scale,
                                 next_inv, out, oh, ow)


def _block_op_plain(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv, out):
    return conv_int8_block_ref(x, w, stride, _pair_pads(pads), a, b, residual, res_kind,
                               res_scale, next_inv, out)


def _block_op_fake(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv, out):
    oh, ow = _check(x, w, stride, _pair_pads(pads), a, b)
    outs = _block_outs(x, oh, ow, w.shape[0], out)
    return outs if out == "carry" else outs[0]


@torch.library.custom_op("deephisto::conv_int8_block", mutates_args=(), device_types="cuda")
def _conv_int8_block_op(x: torch.Tensor, w: torch.Tensor, stride: int, pads: list[int],
                        a: torch.Tensor, b: torch.Tensor, residual: torch.Tensor | None,
                        res_kind: str, res_scale: torch.Tensor | None,
                        next_inv: torch.Tensor | None, out: str) -> torch.Tensor:
    return _block_op_card(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                          out)


_conv_int8_block_op.register_kernel("cpu")(_block_op_plain)
_conv_int8_block_op.register_fake(_block_op_fake)


@torch.library.custom_op("deephisto::conv_int8_block_carry", mutates_args=(),
                         device_types="cuda")
def _conv_int8_block_carry_op(x: torch.Tensor, w: torch.Tensor, stride: int, pads: list[int],
                              a: torch.Tensor, b: torch.Tensor, residual: torch.Tensor | None,
                              res_kind: str, res_scale: torch.Tensor | None,
                              next_inv: torch.Tensor | None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    return _block_op_card(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                          "carry")


@_conv_int8_block_carry_op.register_kernel("cpu")
def _conv_int8_block_carry_op_cpu(x, w, stride, pads, a, b, residual, res_kind, res_scale,
                                  next_inv):
    return _block_op_plain(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                           "carry")


@_conv_int8_block_carry_op.register_fake
def _conv_int8_block_carry_op_fake(x, w, stride, pads, a, b, residual, res_kind, res_scale,
                                   next_inv):
    return _block_op_fake(x, w, stride, pads, a, b, residual, res_kind, res_scale, next_inv,
                          "carry")


# -- the wrappers -------------------------------------------------------------

def conv_int8(x, w, stride: int, pads, a, b, to_int8: bool) -> torch.Tensor:
    """K6's f32 mode, or with ``to_int8`` its relu + requantized int8 mode
    (module docstring). CPU tensors take :func:`conv_int8_ref`; CUDA tensors
    launch the kernel (built at first use) and raise if they cannot."""
    pads = _pads(pads)
    oh, ow = _check(x, w, stride, pads, a, b)
    if torch.compiler.is_compiling():
        return torch.ops.deephisto.conv_int8(x, w, stride, _flat_pads(pads), a, b, to_int8)
    if x.device.type == "cpu":
        return conv_int8_ref(x, w, stride, pads, a, b, to_int8)
    return _conv_int8_card(x, w, stride, pads, a, b, to_int8, oh, ow)


def conv_f32(x, w, stride: int, pads, dequant, bias) -> torch.Tensor:
    """``conv_s32(x, w)·dequant + bias`` in f32 (quantize.py:467-471), K6."""
    return conv_int8(x, w, stride, pads, dequant, bias, to_int8=False)


def conv_to_int8(x, w, stride: int, pads, a, b) -> torch.Tensor:
    """``clip(round(relu(conv_s32(x, w)·a + b)), ±127)`` as int8
    (quantize.py:473-481), K6."""
    return conv_int8(x, w, stride, pads, a, b, to_int8=True)


def conv_int8_block(x, w, stride: int, pads, a, b, residual=None, res_kind: str = "none",
                    res_scale=None, next_inv=None, out: str = "carry"):
    """K6's block mode (module docstring): ``conv_f32``'s value, the residual
    added (``res_kind``), relu, then ``out``: "carry" returns (the bf16 carry,
    the int8 input at ``next_inv``), "int8" the int8 input, "f32" the f32
    block output. ``res_scale`` (an "int8" residual's ``s_in``) and
    ``next_inv`` are one-element f32 tensors on x's device. CPU tensors take
    :func:`conv_int8_block_ref`; CUDA tensors launch the kernel."""
    pads = _pads(pads)
    oh, ow = _check(x, w, stride, pads, a, b)
    cout = w.shape[0]
    _check_block(x, oh, ow, cout, residual, res_kind, res_scale, next_inv, out)
    if torch.compiler.is_compiling():
        args = (x, w, stride, _flat_pads(pads), a, b, residual, res_kind,
                res_scale if res_kind == "int8" else None, next_inv if out != "f32" else None)
        if out == "carry":
            return torch.ops.deephisto.conv_int8_block_carry(*args)
        return torch.ops.deephisto.conv_int8_block(*args, out)
    if x.device.type == "cpu":
        return conv_int8_block_ref(x, w, stride, pads, a, b, residual, res_kind, res_scale,
                                   next_inv, out)
    return _conv_int8_block_card(x, w, stride, pads, a, b, residual, res_kind, res_scale,
                                 next_inv, out, oh, ow)
