"""ViT port vs the flax ViT: the same seeded input and the same weights,
converted flax → torch by ``flax_vit_to_torch``, give the same logits.

The models are narrow (dim 32, 2 heads, depth 2) at patch 8 on 224² inputs,
so the sequence has 784 tokens, the predict shape of the ``vit2p8`` config.
Every weight is random, LayerNorm, GroupNorm and BatchNorm scales, biases
and BN statistics included, so a wrong eps, norm axis or padding shows.

float32: logits within 1e-4, the bound of ``test_torch_resnet.py`` (readings
on the CPU: 3e-7 to 7e-7). bfloat16: the flax model at ``dtype=bfloat16``
(compiled without excess precision) vs the port at bfloat16, held as
``tests/test_vit.py`` holds its bf16 serving rewrite to the float model:
the largest difference under 2e-2 of the largest logit and the same argmax
on every patch (readings: 2.1e-3 to 1.1e-2). XLA-CPU rounds every bf16 op
of the GELU and each Dense before its bias add; torch rounds once per fused
op, so no patch agrees to f32 roundoff here, unlike the ResNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet import _random_variables

from deephisto_tpu.models.patch_cls_simple.model import get_model as jax_get_model
from deephisto_tpu.models.vit import ViT as JViT
from deephisto_tpu_torch.models import ViT, flax_vit_to_torch
from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model

STEMS = ["linear", "conv", "conv_gn"]
NARROW = dict(num_classes=5, patch=8, dim=32, depth=2, heads=2)


def flax_and_torch_vit(stem, dtype=torch.float32, size=224, seed=0):
    """(flax module, its random numpy variables, the port's model in eval
    mode with those weights converted); the flax module is float32."""
    jm = JViT(dtype=jnp.float32, stem=stem, **NARROW)
    shapes = jax.eval_shape(
        jm.init, jax.random.key(seed), jnp.zeros((1, size, size, 3), jnp.float32)
    )
    v = _random_variables(shapes, np.random.default_rng(seed))
    tm = ViT(dtype=dtype, stem=stem, img_size=size, **NARROW)
    tm.load_state_dict(flax_vit_to_torch(v))
    return jm, v, tm.eval()


@pytest.mark.parametrize("stem", STEMS)
def test_logits_match_flax(stem):
    jm, v, tm = flax_and_torch_vit(stem)
    x = np.random.default_rng(1).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stem", STEMS)
def test_bf16_logits_match_flax_bf16(stem):
    _, v, tm = flax_and_torch_vit(stem, dtype=torch.bfloat16)
    jb = JViT(dtype=jnp.bfloat16, stem=stem, **NARROW)
    u8 = np.random.default_rng(2).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    apply = jax.jit(jb.apply, compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(apply(v, jnp.asarray(u8).astype(jnp.bfloat16) / jnp.bfloat16(255)))
    x = torch.from_numpy(u8).to(torch.bfloat16) / torch.tensor(255.0, dtype=torch.bfloat16)
    with torch.no_grad():
        got = tm(x).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_tokens_entry_matches_flax():
    """``tokens=True`` takes (B, gh, gw, dim) stem features and enters at the
    transformer, skipping the stem (vit.py:202-208)."""
    jm, v, tm = flax_and_torch_vit("conv")
    feats = np.random.default_rng(3).normal(size=(2, 28, 28, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply, static_argnames="tokens")(v, jnp.asarray(feats),
                                                                   tokens=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), tokens=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stem", STEMS)
def test_converted_state_dict_covers_the_model(stem):
    _, v, tm = flax_and_torch_vit(stem)
    sd = flax_vit_to_torch(v)
    assert set(sd) == set(tm.state_dict())
    p = v["params"]
    qkv = p["block1"]["attn"]["qkv"]["kernel"]  # (in, 3·dim)
    np.testing.assert_array_equal(sd["block1.attn.qkv.weight"].numpy(), qkv.T)
    np.testing.assert_array_equal(sd["pos_embed"].numpy(), p["pos_embed"])
    np.testing.assert_array_equal(sd["ln.weight"].numpy(), p["ln"]["scale"])
    conv = p["embed"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["embed.weight"].numpy(), np.transpose(conv, (3, 2, 0, 1)))
    assert tm.n_tokens == 28 * 28


@pytest.mark.parametrize(
    "kwargs",
    [dict(depth=0), dict(depth=13), dict(depth=6, stem="s2d")],
)
def test_get_model_vit_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jax_get_model(5, arch="vit", **kwargs)
    with pytest.raises(ValueError) as got:
        get_model(5, arch="vit", **kwargs)
    assert str(got.value) == str(want.value)


def test_get_model_builds_the_vit2p8_config():
    """``get_model(5, arch="vit", depth=6, stem="conv", patch=8)``, the
    ``vit2p8`` config (benchmarks/time_to_accuracy.py:41), is ViT-S wide
    with the JAX factory's fields; ``imagenet`` maps to the linear stem."""
    want = jax_get_model(5, arch="vit", depth=6, stem="conv", patch=8)
    got = get_model(5, arch="vit", depth=6, stem="conv", patch=8)
    fields = ("num_classes", "patch", "dim", "depth", "heads", "stem")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.dtype == torch.bfloat16 and got.n_tokens == 784
    assert [got.get_submodule(f"stem_conv{i}").out_channels for i in range(3)] == [96, 192, 384]
    assert get_model(5, arch="vit", depth=1, stem="imagenet").stem == "linear"
    with pytest.raises(ValueError, match="arch must be"):
        get_model(5, arch="vgg")


def test_init_model_vit_is_seeded_and_flax_like():
    a = init_model(get_model(5, arch="vit", depth=1, dtype=torch.float32), seed=3)
    b = init_model(get_model(5, arch="vit", depth=1, dtype=torch.float32), seed=3)
    c = init_model(get_model(5, arch="vit", depth=1, dtype=torch.float32), seed=4)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["block0.fc1.weight"], c.state_dict()["block0.fc1.weight"])
    assert abs(float(a.pos_embed.detach().std()) - 0.02) < 2e-3
    assert not a.block0.attn.qkv.bias.any() and not a.embed.bias.any()
    assert torch.equal(a.block0.ln1.weight, torch.ones(384))
    # lecun normal: variance 1/fan_in
    assert abs(float(a.block0.fc1.weight.detach().var()) * 384 - 1.0) < 0.05
    with torch.no_grad():
        out = init_model(get_model(5, arch="vit", depth=1, input_size=32), seed=0)(
            torch.rand(2, 32, 32, 3))
    assert out.dtype == torch.float32 and out.shape == (2, 5)
