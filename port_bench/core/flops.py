"""The yardstick's arithmetic: operations and bytes computed from the
configuration's shapes, never from the kernels that do the work, and the
H100's peaks (NVIDIA H100 SXM data sheet, dense rates, at its 700 W
limit).

Operations count 2 a multiply-add. A conv's bytes are its input, kernel
and per-channel constants read once, its residual read once and its
outputs written once (an int8 conv of the int8 ResNet: the f32, int8 and
bf16-carry + int8 outputs of its three modes)."""

from __future__ import annotations

from ..reference.maps import dense_coords

PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12}  # per second, tensor cores
HBM_BYTES_PER_S = 3.35e12
OUT_BYTES = {"f32": 4, "int8": 1, "carry": 3}
RES_BYTES = {"none": 0, "bf16": 2, "f32": 4, "int8": 1}


def equivalent_patches(h: int, w: int, ps: int = 224, stride: int = 112) -> int:
    """Exact-mode patches of a slide: what both modes' patches/s count."""
    return len(dense_coords(h, w, ps, stride))


def _out(n: int, s: int) -> int:
    return -(-n // s)


def resnet_convs(model: dict, h: int, w: int) -> list[dict]:
    """Every conv of the s2d-stem BasicBlock ResNet on one (h, w) image, in
    execution order: input extent and channels, output extent and channels,
    kernel, and the int8 model's mode (``f32``, ``int8`` or ``block``),
    residual kind and output kind."""
    widths = [model["width"] * 64 * 2**i for i in range(len(model["stage_sizes"]))]
    ih, iw = h // 4, w // 4
    convs = [dict(ih=ih, iw=iw, cin=48, oh=ih, ow=iw, cout=widths[0], k=2, mode="block",
                  res="none", out="carry")]
    cin = widths[0]
    n_blocks = sum(model["stage_sizes"])
    b = 0
    for i, count in enumerate(model["stage_sizes"]):
        for j in range(count):
            b += 1
            s = 2 if i > 0 and j == 0 else 1
            oh, ow = _out(ih, s), _out(iw, s)
            cout = widths[i]
            ds = cin != cout or s != 1
            convs.append(dict(ih=ih, iw=iw, cin=cin, oh=oh, ow=ow, cout=cout, k=3, mode="int8",
                              res="none", out="int8"))
            if ds:
                convs.append(dict(ih=ih, iw=iw, cin=cin, oh=oh, ow=ow, cout=cout, k=1,
                                  mode="f32", res="none", out="f32"))
            convs.append(dict(ih=oh, iw=ow, cin=cout, oh=oh, ow=ow, cout=cout, k=3,
                              mode="block", res="f32" if ds else "bf16",
                              out="f32" if b == n_blocks else "carry"))
            ih, iw, cin = oh, ow, cout
    return convs


def conv_ops(c: dict, n: int = 1) -> float:
    return 2.0 * n * c["oh"] * c["ow"] * c["cout"] * c["k"] * c["k"] * c["cin"]


def conv_bytes(c: dict, n: int = 1) -> float:
    """Bytes one call of the conv over ``n`` images must move."""
    m = n * c["oh"] * c["ow"]
    return (n * c["ih"] * c["iw"] * c["cin"] + c["cout"] * c["k"] * c["k"] * c["cin"]
            + 8 * c["cout"] + 8 + m * c["cout"] * (OUT_BYTES[c["out"]] + RES_BYTES[c["res"]]))


def conv_bound_s(c: dict, n: int, precision: str) -> float:
    """The least time the H100 could take for the conv over ``n`` images:
    operations over the peak or bytes over HBM bandwidth, the larger."""
    return max(conv_ops(c, n) / PEAK_OPS[precision], conv_bytes(c, n) / HBM_BYTES_PER_S)


def resnet_patch_ops(model: dict, ps: int = 224) -> float:
    """Operations of one forward at ps² (the convs; the head is < 0.01 %)."""
    return sum(conv_ops(c) for c in resnet_convs(model, ps, ps))


def vit_patch_ops(model: dict, ps: int = 224) -> float:
    """Operations of one ViT forward at ps²: the patchify conv, per block
    the qkv, attention (Q·Kᵀ and P·V), proj and MLP products."""
    n = (ps // model["patch"]) ** 2
    dim, mlp = model["dim"], model["dim"] * model["mlp_ratio"]
    embed = n * dim * 3 * model["patch"] ** 2
    block = n * dim * 3 * dim + 2 * n * n * dim + n * dim * dim + 2 * n * dim * mlp
    return 2.0 * (embed + model["depth"] * block)


def attention_bound_s(model: dict, n_images: int, ps: int = 224) -> float:
    """The least time of the attention calls of ``n_images`` forwards:
    4·B·H·N²·Dh operations at the bf16 peak, or q, k, v read and the output
    written once in bf16, the larger, summed over the blocks."""
    n = (ps // model["patch"]) ** 2
    ops = 4.0 * n_images * n * n * model["dim"]
    nbytes = 4.0 * n_images * n * model["dim"] * 2
    return model["depth"] * max(ops / PEAK_OPS["bfloat16"], nbytes / HBM_BYTES_PER_S)
