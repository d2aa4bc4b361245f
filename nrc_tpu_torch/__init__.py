"""nrc_tpu_torch — the PyTorch + CUDA port of ``nrc_tpu`` for NVIDIA Hopper.

Module paths and names mirror ``nrc_tpu/`` so each counterpart is easy to
find. Plain tensor code is PyTorch; every Pallas kernel of the JAX package
that the ported path reaches is a hand-written CUDA kernel under ``csrc/``,
built with ``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``).

Device rule: a CUDA tensor launches the kernel or raises; a CPU tensor takes
the kernel's plain PyTorch version (the tests' path). Nothing falls back.

Ported so far: one whole frame with the frequency encoding — the render and
training wavefronts, cache inference, radiance propagation, batch assembly
and the four Adam + EMA steps (kernels K1-K6) — for scenes with the
diffuse, glossy, transmissive and emission-only archetypes, mesh lights,
declared lights (constant, equirect and cube environments, point, spot and
IES lights), textures and stochastic cutout. Scenes above the
BVH threshold (16384 triangles) are traced through a 16-wide BVH built on
the host (``ops/bvh_wide.py``, ``native/``) and walked by the kernels W1/W2;
row fetches go through the gather kernels K7-K9. This package never imports
``jax`` or ``nrc_tpu``.
"""

__version__ = "0.1.0"
