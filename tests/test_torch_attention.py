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
* The backward: ``flash_attention_bwd_ref`` (K4 and K5's plain version, at
  the residuals of ``flash_attention_ref``) vs ``jax.vjp`` of
  ``_attention(use_flash=True)``, the Pallas TPU backward kernels in
  interpret mode, at 196 and 784 tokens (padded to 512 and 1024 there). In
  float32 within 2e-5 (readings: 2e-7 to 3e-7; the interpret-mode kernels
  match the jnp vjp to 7e-7); in bfloat16 within two bf16 steps at the
  largest gradient, 2⁻⁷·max|g| (readings: one step, 3.9e-3 at 0.93). And
  the autograd Function's CPU gradients against autograd through
  ``flash_attention_ref``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deephisto_tpu.models.vit import _attention
from deephisto_tpu_torch.models import vit as tvit
from deephisto_tpu_torch.ops import (
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_qkv,
    flash_attention_ref,
)

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
@pytest.mark.parametrize("shape", [(2, 3, 50, 16), (1, 2, 196, 64), (2, 2, 50, 32),
                                   (1, 2, 40, 128)])
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
    qkv = torch.stack([q, k, v], dim=1).permute(0, 3, 1, 2, 4)  # (B, N, 3, H, Dh)
    assert torch.equal(tvit._attention(qkv, use_flash=True),
                       flash_attention_ref(q, k, v, 32**-0.5))
    assert torch.equal(tvit._attention(qkv, use_flash=False), attention_plain(q, k, v))


def test_flash_attention_qkv_gradient_is_the_three_gradients_stacked():
    """On the CPU, ``flash_attention_qkv``'s value is ``flash_attention`` on
    the three views of qkv, and its gradient of qkv holds, bit for bit, the
    gradients that ``flash_attention`` gives q, k and v taken apart."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 3, 2, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 2, 40, 32)).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    out = flash_attention_qkv(a, 0.2)
    (out * w).sum().backward()
    q, k, v = (qkv[:, :, i].transpose(1, 2).clone().requires_grad_(True) for i in range(3))
    want = flash_attention(q, k, v, 0.2)
    (want * w).sum().backward()
    assert torch.equal(out.detach(), want.detach())
    for i, t in enumerate((q, k, v)):
        assert torch.equal(a.grad[:, :, i].transpose(1, 2), t.grad), i


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


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 2, 196, 64), (1, 1, 784, 64)])
def test_flash_bwd_ref_matches_jax_flash_kernel_vjp(shape, name):
    arrays = _qkv(shape, seed=2) + [np.random.default_rng(3).normal(size=shape).astype(np.float32)]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrays, name)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: _attention(q, k, v, use_flash=True), jq, jk, jv)
        want = [_j32(g) for g in vjp(jdo)]
    scale = shape[-1] ** -0.5
    out, lse = flash_attention_ref(tq, tk, tv, scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == shape[:3]
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, scale)
    for g, w in zip(got, want):
        assert g.dtype == tq.dtype and g.shape == shape
        atol = 2e-5 if name == "float32" else 2.0**-7 * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol)


def test_flash_ref_lse_is_the_log_sum_exp():
    q, k, v = map(torch.from_numpy, _qkv((2, 3, 70, 32), seed=4))
    out, lse = flash_attention_ref(q, k, v, 0.3, return_lse=True)
    want = torch.logsumexp(torch.matmul(q.double(), k.double().transpose(-1, -2)) * 0.3, dim=-1)
    torch.testing.assert_close(lse.double(), want, atol=1e-5, rtol=0)
    assert torch.equal(out, flash_attention_ref(q, k, v, 0.3))


@pytest.mark.parametrize("name", list(DTYPES))
def test_flash_attention_function_gradients_on_the_cpu(name):
    """Through autograd on the CPU the Function runs the plain forward and
    backward; its gradients are autograd's through ``flash_attention_ref``:
    float32 within 2e-6 (sums in another order), bfloat16 within two bf16
    steps at the largest gradient, 2⁻⁷·max|g| (the Function rounds P and dS
    to bf16 before their products, as the TPU kernels do; autograd rounds
    where the casts of the forward put it; readings: one step)."""
    tdt = DTYPES[name][1]
    q, k, v, w = (torch.from_numpy(a).to(tdt) for a in _qkv((2, 3, 90, 32), seed=5) + _qkv(
        (2, 3, 90, 32), seed=6)[:1])
    grads = []
    for fn in (flash_attention, flash_attention_ref):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        (fn(qq, kk, vv, 0.25).float() * w.float()).sum().backward()
        grads.append([t.grad for t in (qq, kk, vv)])
    for g, want in zip(*grads):
        atol = 2e-6 if name == "float32" else 2.0**-7 * float(want.float().abs().max())
        torch.testing.assert_close(g.float(), want.float(), atol=atol, rtol=0)
    out, lse = flash_attention_ref(q, k, v, 0.25, return_lse=True)
    direct = flash_attention_bwd(q, k, v, out, lse, w, 0.25)
    assert all(torch.equal(a, b) for a, b in zip(direct, flash_attention_bwd_ref(
        q, k, v, out, lse, w, 0.25)))
