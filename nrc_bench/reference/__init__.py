"""The benchmark's plain reference: the port's frame in plain PyTorch.

A frozen copy of the port's plain paths (``nrc_tpu_torch`` at the commit
that added the benchmark), which the port runs on the CPU and tests
against the JAX package; here they run on the card as well, with TF32 off,
and no kernel of the port is used:

- ``config.py``, ``utils/``, ``scene/`` (camera, materials, lights),
  ``ops/`` (BSDFs, light sampling, encodings) and ``render/integrator.py``
  are copies, cut to what the benchmark's scenes use: triangles under mesh
  lights with the archetypes of ``ops/bsdf.py``. The port's textures,
  cutouts, media, layered, measured, noise and hair materials, declared
  lights and the image loaders are not copied, and a scene that needs one
  is refused. Each module's docstring is the port's, where "on the card"
  read "the kernel" and here reads the plain version below;
- ``ops/gather.py`` (``table[idx]`` for K7-K9), ``ops/planes.py`` (K1/K2's
  plane test over every triangle), ``ops/brute.py`` (Möller-Trumbore over
  every triangle of the boxes a ray meets, for the walks W1/W2 and the
  raster R1; no BVH is built), ``ops/hash_grid.py`` (H1/H2's lookup and
  f32 scatter-add) and ``ops/mlp.py`` (K3-K6, operands rounded by a
  function: bf16 as configured, fp8 for the control) take the kernels'
  places;
- ``render/frame.py`` is ``frame_step`` without the raster, and
  ``sampled_frame``: the frame for a set of pixels;
- ``render/scene_device.py`` derives every table from the host scene and
  builds no BVH; ``scene/build.py`` makes the host scene from the
  benchmark's ``SceneData``.

Nothing here imports ``nrc_tpu_torch``, ``nrc_tpu`` or JAX, and nothing
takes a table, weight or batch that the program made: the network state a
frame starts from is the program's, handed over by the harness.
"""
