"""``deephisto_tpu_torch.export``: the classifier as a ``torch.export``
program with its weights baked in, against the JAX package's StableHLO
export and the live port model, on the CPU.

* ResNet-18 float32 (32², batch 4, 16 filters) on the JAX package's random weights,
  converted: the loaded program within 1e-5 of JAX's
  ``load_classifier(export_classifier(...))`` (tests/test_export.py's
  tolerance) and bit-equal to the live port model.
* A depth-2 ViT at 196 tokens, the int8 ResNet-18 (s2d) and the int8 ViT:
  the graph holds the port's registered ops (K3 as
  ``deephisto::flash_attention``, K6 as ``deephisto::conv_int8*``), whose CPU
  implementations are the kernels' plain versions, and the loaded program is
  bit-equal to the live model run on the same route. The export records the
  card's route (K3 from ``FLASH_MIN_SEQ`` tokens) whatever the device, where
  the live CPU model runs the plain attention, so the live ViTs are run with
  K3's plain version for the bit comparison.
* A fresh Python process loads the artifact and gives the same logits.
"""

import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deephisto_tpu.export import export_classifier as jax_export_classifier
from deephisto_tpu.export import load_classifier as jax_load_classifier
from deephisto_tpu.models.resnet import ResNet18 as JResNet18
from deephisto_tpu_torch.export import Classifier, export_classifier, load_classifier
from deephisto_tpu_torch.models import ResNet18, flax_resnet_to_torch, quantize_model
from deephisto_tpu_torch.models import vit as vit_module
from deephisto_tpu_torch.models.patch_cls_simple import get_model, init_model
from deephisto_tpu_torch.models.vit import ViT

from test_torch_resnet import _random_variables


def _patches(b, ps, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, ps, ps, 3), dtype=np.uint8)


def _ops(data: bytes) -> set[str]:
    graph = torch.export.load(io.BytesIO(data)).graph
    return {str(n.target) for n in graph.nodes if "deephisto" in str(n.target)}


def test_resnet18_export_matches_jax_and_the_live_model(tmp_path):
    ps, b = 32, 4
    jm = JResNet18(num_classes=5, num_filters=16, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, ps, ps, 3)))
    v = _random_variables(shapes, np.random.default_rng(0))
    model = ResNet18(num_classes=5, num_filters=16, dtype=torch.float32)
    model.load_state_dict(flax_resnet_to_torch(v))

    data = export_classifier(model, b, ps, path=tmp_path / "classifier", device="cpu")
    assert (tmp_path / "classifier.pt2").read_bytes() == data
    assert not _ops(data)  # the float ResNet runs no hand kernel
    x = _patches(b, ps)
    got = load_classifier(tmp_path / "classifier.pt2")(torch.from_numpy(x))
    assert got.shape == (b, 5) and got.dtype == torch.float32
    with torch.no_grad():
        assert torch.equal(got, Classifier(model)(torch.from_numpy(x)))
    jfn = jax_load_classifier(jax_export_classifier(jm, v, batch_size=b, patch_size=ps))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=0, atol=1e-5)


def _k3_plain_route(monkeypatch):
    """Run the live ViTs on the route the export records: K3 (its plain
    version on the CPU) from FLASH_MIN_SEQ tokens."""
    monkeypatch.setattr(vit_module, "use_flash",
                        lambda qkv: qkv.shape[1] >= vit_module.FLASH_MIN_SEQ)


def _vit(dtype):
    # patch 4 on 56² gives 196 tokens: FLASH_MIN_SEQ
    return init_model(ViT(5, patch=4, dim=32, depth=2, heads=2, dtype=dtype, img_size=56),
                      seed=0)


def _int8_resnet():
    from deephisto_tpu_torch.models import quantize_resnet

    calib = [torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(2))]
    return quantize_resnet(init_model(get_model(3, depth=18, stem="s2d", dtype=torch.float32),
                                      seed=1), calib)


def _int8_vit():
    calib = [torch.rand(4, 56, 56, 3, generator=torch.Generator().manual_seed(3))]
    return quantize_model(_vit(torch.bfloat16), calib)


CASES = {
    "vit": (lambda: _vit(torch.float32), 56, {"deephisto.flash_attention.default"}),
    "int8_resnet": (_int8_resnet, 32, {"deephisto.conv_int8.default",
                                        "deephisto.conv_int8_block.default",
                                        "deephisto.conv_int8_block_carry.default"}),
    "int8_vit": (_int8_vit, 56, {"deephisto.flash_attention.default",
                                  "deephisto.conv_int8.default"}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernels_are_registered_ops_in_the_program(name, monkeypatch):
    make, ps, ops = CASES[name]
    model = make()
    assert vit_module.FLASH_MIN_SEQ == 196
    data = export_classifier(model, 2, ps, device="cpu")
    assert _ops(data) == ops
    x = torch.from_numpy(_patches(2, ps, seed=5))
    got = load_classifier(data)(x)
    _k3_plain_route(monkeypatch)
    with torch.no_grad():
        want = Classifier(model)(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_a_fresh_process_loads_the_artifact(tmp_path):
    model = _vit(torch.float32)
    path = tmp_path / "vit.pt2"
    export_classifier(model, 2, 56, path=path, device="cpu")
    x = _patches(2, 56, seed=7)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import numpy as np, torch\n"
        "from deephisto_tpu_torch.export import load_classifier\n"
        f"fn = load_classifier({str(path)!r})\n"
        f"y = fn(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(Path(__file__).resolve().parents[1]))
    assert np.array_equal(np.load(tmp_path / "y.npy"),
                          load_classifier(path)(torch.from_numpy(x)).numpy())
