"""The 132,272-triangle scene (the program's large-scene path: the wide
BVH walks W1/W2, and the primary raster R1 while the camera holds still).

A frozen copy of ``nrc_tpu_torch/scene/scene_builder.py::cornell_objects``:
the Cornell box's walls, light, camera and system settings around a diffuse
sphere of radius 4 (256 x 128, 65,536 triangles) and a GGX-reflect torus
(ring radius 3, tube radius 1, 256 x 128, 65,536 triangles) on the floor.
"""

from __future__ import annotations

from . import Model, scale, translate
from .cornell_box import CAMERA, MATERIALS, SYSTEM, walls

TESSELLATION = (256, 128)  # 2 x 256 x 128 = 65,536 triangles per object


def declarations():
    tu, tv = TESSELLATION
    models = walls() + [
        Model("sphere", translate(-4, -6, -3) @ scale(4.0), "white", (tu, tv, 1.0)),
        Model("torus", translate(4, -9, 3), "glossy", (tu, tv, 1.0, 3.0)),
    ]
    return models, MATERIALS, CAMERA, SYSTEM
