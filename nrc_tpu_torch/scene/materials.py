"""Parametric material rows and the SoA material table (NumPy).

Port of ``nrc_tpu/scene/materials.py:24-311``: the BSDF archetype enum, one
``Material`` row with every knob of the reference's MDL sample set, and
``MaterialTable.build``. The table keeps every column of the JAX package's
table, so ``render/scene_device.py`` assembles the same merged material row.

``build`` resolves the three texture paths of a row into ids of the
table's ``TextureAtlas`` (``scene/texture.py``), and loads each distinct
measured-BSDF path once (``scene/mbsdf.py::load_measurement``), stacking
the measurements into the table's ``MBSDFTableHost`` in the order of first
use, as the JAX package does (``nrc_tpu/scene/materials.py:232-244``); a
material's ``mbsdf_index`` is its measurement's place there, -1 without
one. The loaded measurements stay in the table by path
(``measurements``), so that a live edit that passes them on reads no file
again, as it decodes no texture again.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional, Tuple

import numpy as np

from .mbsdf import Measurement, MBSDFTableHost, load_measurement
from .texture import TextureAtlas

# resampled measured-curve resolution (``nrc_tpu/ops/layered.py:53``)
CURVE_RES = 16


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
    # homogeneous volume coefficients (entered on transmission)
    sigma_a: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    sigma_s: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    volume_bias: float = 0.0   # HG phase anisotropy g
    cutout_opacity: float = 1.0
    # chiang hair BSDF parameters
    hair_roughness: Tuple[Tuple[float, float], ...] = (
        (0.1, 0.1), (0.2, 0.2), (0.3, 0.3),
    )
    hair_absorption: Tuple[float, float, float] = (0.02, 0.3, 0.6)
    hair_cuticle_angle: float = 0.0524
    hair_diffuse_weight: float = 0.0
    # measured BSDF (df::measured_bsdf): an .npz or MERL .binary file
    mbsdf_path: str = ""
    mbsdf_multiplier: float = 1.0
    # 2D textures: albedo and emission tints, cutout opacity (its RGB mean)
    albedo_tex_path: str = ""
    albedo_tex_srgb: bool = True
    cutout_tex_path: str = ""
    emission_tex_path: str = ""
    emission_tex_srgb: bool = True
    uv_scale: Tuple[float, float] = (1.0, 1.0)
    uv_translation: Tuple[float, float] = (0.0, 0.0)
    uv_rotation_z: float = 0.0  # radians
    # second lobe + blend/modifier descriptor (MDL combinators)
    archetype2: Archetype = Archetype.NULL_BSDF
    albedo2: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness2: Tuple[float, float] = (0.0, 0.0)
    blend_mode: int = 0
    blend_w1: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    blend_w2: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    blend_ior: float = 1.5
    curve_values: Tuple[Tuple[float, float, float], ...] = ()
    mod_mode: int = 0
    mod_a: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mod_b: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    mod_exp: float = 1.0
    # procedural noise tint
    noise_mode: int = 0
    noise_color1: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    noise_color2: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    noise_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    noise_levels: int = 3
    noise_absolute: bool = False
    noise_thr_low: float = 0.0
    noise_thr_high: float = 1.0
    noise_marble: bool = False
    noise_target: int = 0
    noise_bump_factor: float = 0.0

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
    sigma_a: np.ndarray             # [M, 3] f32
    sigma_s: np.ndarray             # [M, 3] f32
    volume_bias: np.ndarray         # [M] f32
    cutout_opacity: np.ndarray      # [M] f32
    hair_roughness: np.ndarray      # [M, 3, 2] f32
    hair_absorption: np.ndarray     # [M, 3] f32
    hair_cuticle_angle: np.ndarray  # [M] f32
    hair_diffuse_weight: np.ndarray  # [M] f32
    albedo_tex: np.ndarray          # [M] int32 atlas id (-1 = none)
    cutout_tex: np.ndarray          # [M] int32
    emission_tex: np.ndarray        # [M] int32
    uv_xf: np.ndarray               # [M, 6] f32: su, sv, tu, tv, cos_rz, sin_rz
    archetype2: np.ndarray          # [M] int32
    albedo2: np.ndarray             # [M, 3]
    roughness2: np.ndarray          # [M, 2]
    blend_mode: np.ndarray          # [M] int32
    blend_w1: np.ndarray            # [M, 3]
    blend_w2: np.ndarray            # [M, 3]
    blend_ior: np.ndarray           # [M]
    curve: np.ndarray               # [M, CURVE_RES, 3] resampled curves
    mod_mode: np.ndarray            # [M] int32
    mod_a: np.ndarray               # [M, 3]
    mod_b: np.ndarray               # [M, 3]
    mod_exp: np.ndarray             # [M]
    mbsdf_index: np.ndarray         # [M] int32 (-1 = none)
    mbsdf_multiplier: np.ndarray    # [M] f32
    noise_mode: np.ndarray          # [M] int32
    noise_color1: np.ndarray        # [M, 3]
    noise_color2: np.ndarray        # [M, 3]
    noise_scale: np.ndarray         # [M, 3]
    noise_levels: np.ndarray        # [M] int32
    noise_absolute: np.ndarray      # [M] int32
    noise_thr: np.ndarray           # [M, 2] low/high
    noise_marble: np.ndarray        # [M] int32
    noise_target: np.ndarray        # [M] int32
    noise_bump_factor: np.ndarray   # [M] f32
    atlas: TextureAtlas = None      # the decoded textures the ids index
    mbsdf: MBSDFTableHost = None    # the stacked measurements mbsdf_index indexes
    measurements: Optional[Dict[str, Measurement]] = None  # loaded, by path

    @staticmethod
    def build(materials: list[Material], atlas: Optional[TextureAtlas] = None,
              measurements: Optional[Dict[str, Measurement]] = None) -> "MaterialTable":
        """The table of ``materials``. ``atlas``: an existing atlas to add the
        textures to (its (path, sRGB) dedup makes a texture it holds free),
        and ``measurements``: measurements already loaded, by path, as a
        live edit passes them so that no image or measurement is read again
        (``nrc_tpu/scene/materials.py:185-270``)."""
        if not materials:
            materials = [Material()]
        if atlas is None:
            atlas = TextureAtlas.empty()

        def tex(path: str, srgb: bool) -> int:
            return atlas.add(path, srgb) if path else -1

        def arr(field, dtype):
            return np.asarray([getattr(m, field) for m in materials], dtype)

        def iarr(field):
            return np.asarray([int(getattr(m, field)) for m in materials], np.int32)

        uv_xf = np.asarray(
            [
                [
                    m.uv_scale[0], m.uv_scale[1],
                    m.uv_translation[0], m.uv_translation[1],
                    math.cos(m.uv_rotation_z), math.sin(m.uv_rotation_z),
                ]
                for m in materials
            ],
            np.float32,
        )
        curve = np.ones((len(materials), CURVE_RES, 3), np.float32)
        for i, m in enumerate(materials):
            cv = np.asarray(m.curve_values, np.float32)
            if cv.size:
                x_src = np.linspace(0.0, 1.0, cv.shape[0])
                x_dst = np.linspace(0.0, 1.0, CURVE_RES)
                for c in range(3):
                    curve[i, :, c] = np.interp(x_dst, x_src, cv[:, c])

        # measured BSDFs: dedup by path, stacked into one table set
        measurements = dict(measurements or {})
        paths: list[str] = []
        mbsdf_index = np.full(len(materials), -1, np.int32)
        for i, m in enumerate(materials):
            if m.mbsdf_path:
                if m.mbsdf_path not in paths:
                    paths.append(m.mbsdf_path)
                mbsdf_index[i] = paths.index(m.mbsdf_path)
        for path in paths:
            if path not in measurements:
                measurements[path] = load_measurement(path)

        f32 = np.float32
        return MaterialTable(
            archetype=iarr("archetype"),
            albedo=arr("albedo", f32),
            roughness=arr("roughness", f32),
            ior=arr("ior", f32),
            thin_walled=iarr("thin_walled"),
            emission_intensity=arr("emission_intensity", f32),
            emission_mode=iarr("emission_mode"),
            sigma_a=arr("sigma_a", f32),
            sigma_s=arr("sigma_s", f32),
            volume_bias=arr("volume_bias", f32),
            cutout_opacity=arr("cutout_opacity", f32),
            hair_roughness=arr("hair_roughness", f32),
            hair_absorption=arr("hair_absorption", f32),
            hair_cuticle_angle=arr("hair_cuticle_angle", f32),
            hair_diffuse_weight=arr("hair_diffuse_weight", f32),
            albedo_tex=np.asarray([tex(m.albedo_tex_path, m.albedo_tex_srgb) for m in materials], np.int32),
            cutout_tex=np.asarray([tex(m.cutout_tex_path, False) for m in materials], np.int32),
            emission_tex=np.asarray([tex(m.emission_tex_path, m.emission_tex_srgb) for m in materials],
                                    np.int32),
            uv_xf=uv_xf,
            archetype2=iarr("archetype2"),
            albedo2=arr("albedo2", f32),
            roughness2=arr("roughness2", f32),
            blend_mode=iarr("blend_mode"),
            blend_w1=arr("blend_w1", f32),
            blend_w2=arr("blend_w2", f32),
            blend_ior=arr("blend_ior", f32),
            curve=curve,
            mod_mode=iarr("mod_mode"),
            mod_a=arr("mod_a", f32),
            mod_b=arr("mod_b", f32),
            mod_exp=arr("mod_exp", f32),
            mbsdf_index=mbsdf_index,
            mbsdf_multiplier=arr("mbsdf_multiplier", f32),
            noise_mode=iarr("noise_mode"),
            noise_color1=arr("noise_color1", f32),
            noise_color2=arr("noise_color2", f32),
            noise_scale=arr("noise_scale", f32),
            noise_levels=iarr("noise_levels"),
            noise_absolute=iarr("noise_absolute"),
            noise_thr=np.asarray(
                [(m.noise_thr_low, m.noise_thr_high) for m in materials], f32
            ),
            noise_marble=iarr("noise_marble"),
            noise_target=iarr("noise_target"),
            noise_bump_factor=arr("noise_bump_factor", f32),
            atlas=atlas,
            mbsdf=MBSDFTableHost.build([measurements[p] for p in paths]),
            measurements={p: measurements[p] for p in paths},
        )
