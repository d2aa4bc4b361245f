"""Parametric material rows and the SoA material table (NumPy).

Port of ``nrc_tpu/scene/materials.py:24-311``: the BSDF archetype enum, one
``Material`` row and ``MaterialTable.build``, cut to the columns of the
benchmark's scenes: the lobe, its tint, roughness and IOR, thin walls and
emission. The port's texture, cutout, medium, hair, measured, layered and
noise columns are not copied; a scene data row that sets one is refused
(``Material`` has no such field).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np


class Archetype(enum.IntEnum):
    """BSDF archetypes (same ids as the JAX package)."""

    DIFFUSE_REFLECTION = 0     # df::diffuse_reflection_bsdf
    GGX_REFLECT = 1            # df::microfacet_ggx_* / simple_glossy, scatter_reflect
    GGX_TRANSMIT = 2           # ... scatter_transmit
    GGX_REFLECT_TRANSMIT = 3   # ... scatter_reflect_transmit
    SPECULAR_REFLECT = 4       # df::specular_bsdf, scatter_reflect
    SPECULAR_TRANSMIT = 5      # ... scatter_transmit
    SPECULAR_REFLECT_TRANSMIT = 6  # ... scatter_reflect_transmit (glass)
    DIFFUSE_TRANSMISSION = 7   # df::diffuse_transmission_bsdf
    NULL_BSDF = 8              # emission-only materials (black bsdf ends path)
    HAIR = 9                   # df::chiang_hair_bsdf (curve primitives)
    MEASURED = 10              # df::measured_bsdf


NUM_ARCHETYPES = len(Archetype)


class EmissionMode(enum.IntEnum):
    NONE = 0
    RADIANT_EXITANCE = 1  # intensity_radiant_exitance: radiance = I / pi
    POWER = 2             # intensity_power: divide by surface area


@dataclasses.dataclass
class Material:
    """One material row. Mirrors the knobs MDL exposes in the sample set."""

    name: str = "default"
    archetype: Archetype = Archetype.DIFFUSE_REFLECTION
    albedo: Tuple[float, float, float] = (1.0, 1.0, 1.0)   # tint
    roughness: Tuple[float, float] = (0.0, 0.0)            # (u, v)
    ior: float = 1.5
    thin_walled: bool = False
    emission_intensity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_mode: EmissionMode = EmissionMode.NONE

    @property
    def is_emissive(self) -> bool:
        return self.emission_mode != EmissionMode.NONE and any(
            c > 0.0 for c in self.emission_intensity
        )


@dataclasses.dataclass
class MaterialTable:
    """SoA material parameter table (float32/int32 arrays, one row per material)."""

    archetype: np.ndarray           # [M] int32
    albedo: np.ndarray              # [M, 3] f32
    roughness: np.ndarray           # [M, 2] f32
    ior: np.ndarray                 # [M] f32
    thin_walled: np.ndarray         # [M] int32
    emission_intensity: np.ndarray  # [M, 3] f32
    emission_mode: np.ndarray       # [M] int32

    @staticmethod
    def build(materials: list[Material]) -> "MaterialTable":
        """The table of ``materials`` (``nrc_tpu/scene/materials.py:185-270``)."""
        if not materials:
            materials = [Material()]

        def arr(field, dtype):
            return np.asarray([getattr(m, field) for m in materials], dtype)

        def iarr(field):
            return np.asarray([int(getattr(m, field)) for m in materials], np.int32)

        f32 = np.float32
        return MaterialTable(
            archetype=iarr("archetype"),
            albedo=arr("albedo", f32),
            roughness=arr("roughness", f32),
            ior=arr("ior", f32),
            thin_walled=iarr("thin_walled"),
            emission_intensity=arr("emission_intensity", f32),
            emission_mode=iarr("emission_mode"),
        )
