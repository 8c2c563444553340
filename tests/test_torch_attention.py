"""The port's attention (``deephisto_tpu_torch/ops/attention.py``) against the
JAX ViT's ``_attention``, on the same numpy-seeded (B, H, N, Dh) inputs.

* ``flash_attention_ref`` (K3's plain version) vs ``_attention(use_flash=True)``,
  the Pallas TPU flash kernel run in interpret mode as ``tests/test_vit.py``
  runs it. All three lengths take the kernel's padded path (N to a multiple
  of 512, pad tokens masked by segment ids). In float32 within 2e-5, the
  bound ``tests/test_vit.py`` holds the kernel to (readings on the CPU:
  6e-7). In bfloat16 within two bf16 steps at the largest output,
  2⁻⁷·max|out|: the two round P to bf16 against different running maxima
  (the kernel against the block's, the plain version against the row's),
  and the output once more (readings: one step, 3.9e-3 at max 0.73).
* ``attention_plain`` vs ``_attention(use_flash=False)``, the jnp branch it
  ports: float32 within 2e-6, bfloat16 within one bf16 step at the largest
  output (the products are summed in another order; readings 2.4e-4 to
  9.8e-4 at max 0.3-0.76).
* On the CPU, ``flash_attention`` is its plain version, and it refuses what
  the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deephisto_tpu.models.vit import _attention
from deephisto_tpu_torch.models import vit as tvit
from deephisto_tpu_torch.ops import attention_plain, flash_attention, flash_attention_ref

SHAPES = [(2, 2, 128, 64), (1, 2, 196, 64), (1, 2, 784, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _both(arrays, name):
    jdt, tdt = DTYPES[name]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _j32(x):
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_ref_matches_jax_flash_kernel(shape, name):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape), name)
    with pltpu.force_tpu_interpret_mode():
        want = _j32(_attention(jq, jk, jv, use_flash=True))
    got = flash_attention_ref(tq, tk, tv, shape[-1] ** -0.5)
    assert got.dtype == tq.dtype and got.shape == shape
    atol = 2e-5 if name == "float32" else 2.0**-7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 3, 50, 16), (1, 2, 196, 64)])
def test_attention_plain_matches_jax_jnp_branch(shape, name):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(shape, seed=1), name)
    want = _j32(_attention(jq, jk, jv, use_flash=False))
    got = attention_plain(tq, tk, tv)
    assert got.dtype == tq.dtype
    atol = 2e-6 if name == "float32" else 2.0**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_flash_ref_is_softmax_attention(dh):
    """In float32 the plain version is softmax attention computed in float64
    by numpy, to float32 roundoff (sums of up to 128 terms; readings up to
    2.4e-6), at every head width the kernel takes and a ragged N."""
    q, k, v = _qkv((2, 3, 70, dh), seed=dh)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), 0.3).numpy()
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * 0.3
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_flash_attention_on_the_cpu_is_its_plain_version():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv((1, 2, 40, 32)))
    assert torch.equal(flash_attention(q, k, v, 0.2), flash_attention_ref(q, k, v, 0.2))
    assert torch.equal(tvit._attention(q, k, v, use_flash=True),
                       flash_attention_ref(q, k, v, 32**-0.5))
    assert torch.equal(tvit._attention(q, k, v, use_flash=False), attention_plain(q, k, v))


@pytest.mark.parametrize(
    "shape,dtype,match",
    [((1, 2, 40, 48), torch.bfloat16, "Dh in"), ((1, 2, 40, 64), torch.float16, "bfloat16 or"),
     ((2, 40, 64), torch.float32, r"\(B, H, N, Dh\)")],
)
def test_flash_attention_refuses_what_the_kernel_does_not_take(shape, dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, q, q, 0.1)


def test_flash_attention_refuses_mixed_operands_and_other_devices():
    q = torch.zeros((1, 2, 40, 64))
    with pytest.raises(ValueError, match="share shape"):
        flash_attention(q, q[:, :, :39], q, 0.1)
    with pytest.raises(ValueError, match="share shape"):
        flash_attention(q, q.to(torch.bfloat16), q, 0.1)
    m = q.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(m, m, m, 0.1)
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention(q, q, q, 0.0)
