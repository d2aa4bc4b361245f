"""The 1224-triangle Cornell box (brute force in the program: K1/K2).

A frozen copy of ``nrc_tpu_torch/scene/scene_builder.py::
cornell_box_declarations`` and of ``_cornell_scene``'s system settings:
six 10x10-tessellated planes (200 triangles each) and two boxes (12 each);
walls at +-10, an emissive ceiling plane of area 16 at y = 9.9 with
radiant exitance 100, a diffuse tall box and a GGX-reflect cube; camera
centre (0, 0, 15), (phi, theta, fov, distance) = (0.750781, 0.5, 55, 20);
16x16 tiles, path lengths 2-6, 1 spp a frame.
"""

from __future__ import annotations

from . import Model, rotate, scale, translate

MATERIALS = {
    "white": dict(albedo=(0.8, 0.8, 0.8)),
    "red": dict(albedo=(0.8, 0.05, 0.05)),
    "green": dict(albedo=(0.05, 0.8, 0.05)),
    "light": dict(archetype="NULL_BSDF", albedo=(0.0, 0.0, 0.0), emission_intensity=(100.0, 100.0, 100.0),
                  emission_mode="RADIANT_EXITANCE"),
    "glossy": dict(archetype="GGX_REFLECT", albedo=(0.9, 0.9, 0.9), roughness=(0.1, 0.1), ior=1.5),
}
CAMERA = dict(center=(0.0, 0.0, 15.0), phi=0.750781, theta=0.5, fov=55.0, distance=20.0)
SYSTEM = dict(tile_size=(16, 16), path_lengths=(2, 6))


def walls():
    wall = scale(10.0)
    return [
        Model("plane", translate(0, -10, 0) @ wall, "white", (10, 10, 1)),  # floor
        Model("plane", translate(0, 10, 0) @ rotate(2, 180) @ wall, "white", (10, 10, 1)),  # ceiling
        Model("plane", translate(0, 9.9, 0) @ rotate(2, 180) @ scale(2.0), "light", (10, 10, 1)),
        Model("plane", translate(0, 0, -10) @ wall, "white", (10, 10, 2)),  # back
        Model("plane", translate(-10, 0, 0) @ wall, "red", (10, 10, 0)),  # left
        Model("plane", translate(10, 0, 0) @ rotate(1, 180) @ wall, "green", (10, 10, 0)),  # right
    ]


def declarations():
    models = walls() + [
        Model("box", translate(-4, -4, -3) @ rotate(1, 20) @ scale(3, 6, 3), "white"),
        Model("box", translate(4, -7, 3) @ rotate(1, -20) @ scale(3.0), "glossy"),
    ]
    return models, MATERIALS, CAMERA, SYSTEM
