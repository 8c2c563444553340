"""The example CLIs, ported from the repository's ``examples/`` (the JAX
package's): ``python -m deephisto_tpu_torch.examples.<name>``. Each CLI's
body is a function that takes ``device=None`` (the current CUDA device;
``"cpu"`` runs the plain versions of the kernels)."""
