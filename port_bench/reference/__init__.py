"""The plain reference the benchmark judges the program's answers by.

Plain PyTorch and NumPy only: nothing here imports the program, JAX or the
JAX package, and nothing here takes a tensor the program made. The
benchmark hands the reference the raw inputs it generated itself (weights,
slides) and the program's answers to judge; the reference works out
everything else again (BatchNorm folds, calibration, quantized weights,
score maps).
"""

FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "optax", "deephisto_tpu", "deephisto_tpu_torch")
