"""PyTorch/CUDA port of skypilot_tpu's serving compute path.

The JAX package ``skypilot_tpu`` is the reference; this package mirrors
its layout (``ops/``, ``models/``, ``serve/``) so each module has an
obvious counterpart, imports ``torch`` and never ``jax``, and imports
nothing from ``skypilot_tpu``. Hand-written Hopper kernels live under
``csrc/`` and are built by ``nvcc`` at first use
(``ops/cuda_build.py``).
"""
