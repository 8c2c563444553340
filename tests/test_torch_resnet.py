"""ResNet port vs the flax ResNet: the same seeded input and the same weights,
converted flax → torch, give the same logits and feature maps.

Every BN's scale, bias, mean and var is random before converting: the flax
init's zero ``bn2``/``bn3`` scale makes each block's conv path constant and
would hide a wrong SAME padding (models/quantize.py:250-256).
Tolerance rtol=atol=1e-4 in float32: XLA-CPU and oneDNN sum the convs in
different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.models.resnet import ResNet18 as JResNet18
from deephisto_tpu.models.resnet import ResNet50 as JResNet50
from deephisto_tpu_torch.models import ResNet18, ResNet50, flax_resnet_to_torch
from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model
from deephisto_tpu_torch.models.resnet import BasicBlock, same_pads

TOL = dict(rtol=1e-4, atol=1e-4)
_CTORS = {18: (JResNet18, ResNet18), 50: (JResNet50, ResNet50)}


def _random_variables(tree, rng):
    """numpy variables shaped as the flax ``tree`` (from ``jax.eval_shape``,
    so nothing is compiled): lecun-normal kernels, and every BN scale, bias,
    mean and var drawn at random."""
    out = {}
    for k, v in tree.items():
        shape = v.shape if not hasattr(v, "items") else None
        if shape is None:
            out[k] = _random_variables(v, rng)
        elif k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            out[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:  # BN bias and mean, fc bias
            out[k] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return out


def flax_and_torch_resnet(depth, stem="imagenet", num_filters=8, size=64, seed=0):
    """(flax module, its random numpy variables, the port's model in eval
    mode with those weights converted), all float32."""
    jctor, tctor = _CTORS[depth]
    jm = jctor(num_classes=5, num_filters=num_filters, dtype=jnp.float32, stem=stem)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(seed), jnp.zeros((1, size, size, 3), jnp.float32)
    )
    v = _random_variables(shapes, np.random.default_rng(seed))
    tm = tctor(num_classes=5, num_filters=num_filters, dtype=torch.float32, stem=stem)
    tm.load_state_dict(flax_resnet_to_torch(v))
    return jm, v, tm.eval()


def _pair(depth, stem="imagenet", num_filters=8, size=64, seed=0):
    jm, v, tm = flax_and_torch_resnet(depth, stem, num_filters, size, seed)
    return jax.jit(jm.apply, static_argnames=("features", "up_to")), v, tm


def _x(n, size, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


# 72 px puts a stride-2 conv on an odd extent (SAME pads (1, 1) there)
@pytest.mark.parametrize(
    "depth,stem,size",
    [(18, "imagenet", 64), (18, "imagenet", 72), (18, "s2d", 64), (18, "s2d", 72),
     (50, "imagenet", 64), (50, "s2d", 64)],
)
def test_logits_match_flax(depth, stem, size):
    jm, v, tm = _pair(depth, stem, size=size)
    x = _x(2, size)
    want = np.asarray(jm(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("up_to", ["stem", "layer1", "layer2", "layer3", "layer4"])
def test_up_to_matches_flax(up_to):
    jm, v, tm = _pair(18, size=72)
    x = _x(2, 72)
    want = np.asarray(jm(v, jnp.asarray(x), up_to=up_to))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), up_to=up_to).numpy()
    assert got.shape == want.shape  # NHWC, as the flax model
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stem", ["imagenet", "s2d"])
def test_features_match_flax(stem):
    jm, v, tm = _pair(50, stem, size=64)
    x = _x(2, 64)
    want = np.asarray(jm(v, jnp.asarray(x), features=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), features=True).numpy()
    assert got.shape == want.shape == (2, 2, 2, 8 * 8 * 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_full_width_resnet18_on_two_patches():
    jm, v, tm = _pair(18, num_filters=64, size=224)
    x = _x(2, 224)
    want = np.asarray(jm(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def bf16_logits(depth, stem, seed, n=16, size=64):
    """Logits of the flax model at ``dtype=bfloat16`` (compiled without
    excess precision, so XLA-CPU keeps every bf16 rounding) and of the port
    at bfloat16 and at float32, all with the same converted weights and the
    main path's input, ``bf16(u8) / bf16(255)``."""
    jctor, tctor = _CTORS[depth]
    jm = jctor(num_classes=5, num_filters=8, dtype=jnp.bfloat16, stem=stem)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(seed), jnp.zeros((1, size, size, 3), jnp.float32)
    )
    v = _random_variables(shapes, np.random.default_rng(seed))
    u8 = np.random.default_rng(seed + 1).integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    apply = jax.jit(jm.apply, compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(apply(v, jnp.asarray(u8).astype(jnp.bfloat16) / jnp.bfloat16(255)))
    x = torch.from_numpy(u8).to(torch.bfloat16) / torch.tensor(255.0, dtype=torch.bfloat16)
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        tm = tctor(num_classes=5, num_filters=8, dtype=dt, stem=stem)
        tm.load_state_dict(flax_resnet_to_torch(v))
        with torch.no_grad():
            got[dt] = tm.eval()(x).numpy()
    return want, got


def bf16_agreement(got, want):
    """(share of patches whose logits all agree to 1e-5, largest difference
    over the largest |logit|)."""
    diff = np.abs(got - want)
    return float(np.mean(diff.max(axis=1) < 1e-5)), float(diff.max() / np.abs(want).max())


@pytest.mark.parametrize("depth,stem,seed", [(18, "imagenet", 0), (18, "s2d", 1), (50, "imagenet", 1)])
def test_bf16_logits_match_flax_bf16(depth, stem, seed):
    """The bf16 model rounds where flax's does: BN in f32 on bf16 activations
    and back to bf16, the GAP mean in bf16, fc in f32.

    XLA-CPU and oneDNN sum each bf16 conv in f32 in different orders. The
    sums round to the same bf16 value unless one lies at a rounding boundary;
    such a flip moves every later value of that patch at bf16 scale. So most
    patches agree to the f32 roundoff of the fc (1e-5), and the rest differ
    at bf16 scale. A different rounding point moves every patch. Readings on
    the CPU over seeds 0-5 of depths 18 and 50 with both stems: 56-100 % of
    the patches agreed to 1e-5, the largest difference 2.8 % of the largest
    logit; the f32 model 0 % in every case. At depth 18 over seeds 0-9, an
    f32 GAP mean or bf16 BN parameters gave 0 % too. Hence the bounds: at
    least a third of the patches exact, every logit within 5 % of the scale,
    and the f32 model must fail the first."""
    want, got = bf16_logits(depth, stem, seed)
    exact, rel = bf16_agreement(got[torch.bfloat16], want)
    assert exact >= 1 / 3 and rel <= 5e-2, (exact, rel)
    exact_f32, _ = bf16_agreement(got[torch.float32], want)
    assert exact_f32 < 1 / 3, exact_f32  # the criterion tells f32 from bf16


@pytest.mark.parametrize(
    "n,k,s,want",
    [(8, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (8, 3, 1, (1, 1)), (8, 2, 1, (0, 1)),
     (8, 1, 2, (0, 0)), (7, 7, 2, (3, 3))],
)
def test_same_pads_follow_xla(n, k, s, want):
    assert same_pads(n, k, s) == want


def test_converted_state_dict_covers_the_model():
    _, v, tm = _pair(50, "s2d")
    sd = flax_resnet_to_torch(v)
    assert set(sd) == set(tm.state_dict())
    w = v["params"]["layer2_0"]["conv2"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        sd["layer2_0.conv2.weight"].numpy(), np.transpose(w, (3, 2, 0, 1))
    )
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), v["params"]["fc"]["kernel"].T)


def test_get_model_and_seeded_init():
    m = get_model(5, depth=18, dtype=torch.float32, stem="s2d", width=2)
    assert m.num_filters == 128 and m.stem == "s2d"
    a = init_model(get_model(5, dtype=torch.float32), seed=3).state_dict()
    b = init_model(get_model(5, dtype=torch.float32), seed=3).state_dict()
    c = init_model(get_model(5, dtype=torch.float32), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    m = init_model(get_model(5), seed=0)  # bf16 compute on float32 params, as flax
    assert m.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert m.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    blocks = [b for b in m.modules() if isinstance(b, BasicBlock)]
    assert blocks and not any(b.bn2.weight.any() for b in blocks)
    with torch.no_grad():
        out = m(torch.rand(2, 32, 32, 3))
    assert out.dtype == torch.float32 and out.shape == (2, 5)


def test_vit_is_not_ported_yet():
    """``arch="vit"`` builds the port's ViT now; what of the ViT family is
    not ported yet is its uint8 serving rewrite (the JAX ``FoldedStemViT``,
    ``wants_uint8``), which the predict refuses."""
    from deephisto_tpu_torch.models import ViT
    from deephisto_tpu_torch.predict import predict_full_fused

    m = get_model(5, arch="vit", depth=1, dtype=torch.float32, input_size=64)
    assert isinstance(m, ViT)
    m.wants_uint8 = True
    with pytest.raises(ValueError, match="ROADMAP"):
        predict_full_fused(np.zeros((64, 64, 3), np.uint8), m, 5, patch_size=64, device="cpu")
