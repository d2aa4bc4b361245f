"""Port parity for the mini-MDL reader and the material load report.

``nrc_tpu_torch/scene/mdl.py`` is the JAX package's reader with the
port's constants, so each ``.mdl`` file below must give a ``Material`` with
every field equal to the JAX package's (the two ``Material`` dataclasses
have the same fields), and ``load_material`` the same report entry: "ok"
with the archetype, "not_found", or "parse_error" with the exception. One
file per form ``parse_mdl_material`` handles: each elemental BSDF and
mode, each layer, mix and modifier combinator, the three noises and the
noise bump, measured BSDFs inline and through a let variable, the Chiang
hair BSDF, volume coefficients, every emission form, textures with a uv
placement and a cutout. The files are written under ``tmp_path``, with
the PNG textures and the measurement they name, so that both packages'
``MaterialTable.build`` run on the rows and must give the same arrays.
"""

import dataclasses
import os

import numpy as np
import pytest

from nrc_tpu.scene import materials as JM
from nrc_tpu.scene import mdl as JMDL
from nrc_tpu_torch.scene import materials as PM
from nrc_tpu_torch.scene import mdl as PMDL
from nrc_tpu_torch.scene.mbsdf import bake_ggx
from nrc_tpu_torch.utils.image_io import write_png


def surface(body: str, extra: str = "", params: str = "", lets: str = "") -> str:
    """An exported material with ``body`` inside ``material_surface``."""
    let = f"let {{\n{lets}\n}} in " if lets else ""
    return (f"mdl 1.4;\nimport ::df::*;\nimport ::base::*;\n// a comment: scattering: df::specular_bsdf()\n"
            f"/* block\n comment */\nexport material m({params}) = {let}material(\n"
            f"  surface: material_surface(\n    {body}\n  ){extra}\n);\n")


LEAF = "df::diffuse_reflection_bsdf(tint: color(0.7, 0.6, 0.5))"
GLOSSY = "df::microfacet_ggx_smith_bsdf(roughness_u: 0.2, roughness_v: 0.3, tint: color(0.9), mode: df::scatter_reflect)"

MDL = {
    # elemental BSDFs, their modes, parameters and material-level fields
    "diffuse_params": surface("scattering: df::diffuse_reflection_bsdf(tint: parDiffuseTint)",
                              params="uniform color parDiffuseTint = color(0.25, 0.5, 0.75)"),
    "diffuse_default_tint": surface("scattering: df::diffuse_reflection_bsdf()",
                                    params="color parDiffuseTint = 0.3, float unused = 2"),
    "diffuse_transmission": surface("scattering: df::diffuse_transmission_bsdf(tint: color(0.6))",
                                    extra=",\n  thin_walled: true"),
    "thin_walled_param": surface("scattering: df::diffuse_transmission_bsdf(tint: color(0.6))",
                                 extra=",\n  thin_walled: parThin", params="uniform bool parThin = true"),
    "specular_reflect": surface("scattering: df::specular_bsdf(tint: color(1.0), mode: df::scatter_reflect)"),
    "specular_transmit": surface("scattering: df::specular_bsdf(mode: df::scatter_transmit)",
                                 extra=",\n  ior: color(1.33)"),
    "specular_reflect_transmit": surface("scattering: df::specular_bsdf(mode: df::scatter_reflect_transmit)",
                                         extra=",\n  ior: color(parIor)", params="uniform float parIor = 1.7"),
    "ggx_reflect": surface(f"scattering: {GLOSSY}"),
    "ggx_params": surface("scattering: df::microfacet_ggx_vcavities_bsdf(roughness_u: parRoughness, tint: parGlossyTint)",
                          params="uniform float parRoughness = 0.35, uniform color parGlossyTint = color(0.8, 0.7, 0.6)"),
    "ggx_transmit": surface("scattering: df::microfacet_beckmann_smith_bsdf(roughness_u: 0.1, mode: df::scatter_transmit)"),
    "ggx_reflect_transmit": surface(
        "scattering: df::simple_glossy_bsdf(roughness_u: 0.15, roughness_v: 0.25, mode: df::scatter_reflect_transmit)"),
    "unknown_bsdf": surface("scattering: df::mystery_bsdf(tint: color(0.4))"),
    "null_bsdf": surface("emission: material_emission(emission: df::diffuse_edf(), intensity: color(5.0))"),
    # layers, mixes and modifiers
    "weighted_layer": surface(f"scattering: df::weighted_layer(weight: 0.3, layer: {GLOSSY}, base: {LEAF})"),
    "color_weighted_layer": surface(
        f"scattering: df::color_weighted_layer(weight: color(0.2, 0.4, 0.6), layer: {GLOSSY}, base: {LEAF})"),
    "fresnel_layer": surface(f"scattering: df::fresnel_layer(ior: 1.45, weight: 0.8, layer: {GLOSSY}, base: {LEAF})"),
    "measured_curve_layer": surface(
        "scattering: df::measured_curve_layer(curve_values: color[](color(0.1, 0.2, 0.3), color(0.5), "
        f"color(1.0, 0.9, 0.8)), weight: 0.5, layer: {GLOSSY}, base: {LEAF})"),
    "custom_curve_layer": surface(
        "scattering: df::custom_curve_layer(normal_reflectivity: 0.08, grazing_reflectivity: 0.9, exponent: 3.0, "
        f"weight: 1.0, layer: {GLOSSY}, base: {LEAF})"),
    "normalized_mix": surface(
        "scattering: df::normalized_mix(components: df::bsdf_component[](\n"
        f"      df::bsdf_component(weight: 0.8, component: {GLOSSY}),\n"
        f"      df::bsdf_component(weight: 0.6, component: {LEAF})))"),
    "clamped_mix": surface(
        "scattering: df::clamped_mix(components: df::bsdf_component[](\n"
        f"      df::bsdf_component(weight: 0.7, component: {LEAF}),\n"
        f"      df::bsdf_component(weight: 0.6, component: {GLOSSY})))"),
    "unbounded_mix_one": surface(
        "scattering: df::color_unbounded_mix(components: df::color_bsdf_component[](\n"
        f"      df::color_bsdf_component(weight: color(0.2, 0.3, 0.4), component: {GLOSSY})))"),
    "tint": surface(f"scattering: df::tint(tint: color(0.5, 0.25, 1.0), base: {LEAF})"),
    "directional_factor": surface(
        f"scattering: df::directional_factor(normal_tint: color(1.0), grazing_tint: color(0.3, 0.5, 0.9), "
        f"exponent: 4.0, base: {GLOSSY})"),
    "fresnel_factor": surface(
        "scattering: df::fresnel_factor(ior: color(0.2, 0.4, 1.4), extinction_coefficient: "
        f"math::exp(float3(-parK1, -parK2, -parK3)), base: {GLOSSY})",
        params="uniform float parK1 = 1.5, uniform float parK2 = 1.0, uniform float parK3 = 0.5"),
    "thin_film": surface(f"scattering: df::thin_film(thickness: 450.0, ior: color(1.38), base: {GLOSSY})"),
    "measured_curve_factor": surface(
        "scattering: df::measured_curve_factor(curve_values: color[](color(1.0, 0.5, 0.2), color(0.2, 0.5, 1.0)), "
        f"base: {LEAF})"),
    # procedural noise
    "noise_perlin": surface(
        "scattering: df::diffuse_reflection_bsdf(tint: noise.tint)",
        params="uniform float3 parScale = float3(2.0, 3.0, 4.0), uniform bool parMarble = true",
        lets="    base::texture_return noise = base::perlin_noise_texture(\n"
             "      uvw: base::transform_coordinate(transform: base::rotation_translation_scale("
             "rotation: float3(0.0), translation: float3(0.0), scaling: parScale)),\n"
             "      color1: color(0.1, 0.2, 0.3),\n      color2: color(0.9, 0.8, 0.7),\n"
             "      apply_marble: parMarble,\n      noise_levels: 5,\n      absolute_noise: true,\n"
             "      noise_threshold_low: 0.2,\n      noise_threshold_high: 0.8);"),
    "noise_worley_bump": surface(
        f"scattering: df::fresnel_layer(ior: 1.5, weight: 1.0, layer: {GLOSSY}, base: {LEAF}),\n"
        "    geometry: material_geometry(normal: base::worley_noise_bump_texture(factor: 0.4).normal)",
        lets="    base::texture_return noise = base::worley_noise_texture(color1: color(0.0), color2: color(1.0), "
             "levels: 2);"),
    "noise_flow": surface(
        "scattering: df::diffuse_reflection_bsdf(tint: noise.tint)",
        lets="    base::texture_return noise = base::flow_noise_texture(color1: parC1, color2: color(0.5));",
        params="uniform color parC1 = color(0.2, 0.6, 0.4)"),
    # measured BSDFs
    "measured_inline": surface(
        'scattering: df::measured_bsdf(measurement: bsdf_measurement("meas/ggx.npz"), multiplier: 0.8)'),
    "measured_param": surface("scattering: df::measured_bsdf(measurement: parMeasurement, multiplier: parMult)",
                              params='uniform bsdf_measurement parMeasurement = bsdf_measurement("meas/ggx.npz"), '
                                     "uniform float parMult = 1.25"),
    # the Chiang hair BSDF
    "hair": (
        "mdl 1.4;\nimport ::df::*;\nexport material m(\n"
        "  uniform float2 parRoughR = float2(0.15, 0.25),\n  uniform float parCuticle = 2.5,\n"
        "  uniform color parAbsorptionColor = color(0.3, 0.2, 0.1),\n  uniform float parDiffuse = 0.3\n"
        ") = material(\n  hair: df::chiang_hair_bsdf(\n    diffuse_reflection_weight: parDiffuse,\n"
        "    diffuse_reflection_tint: color(0.9, 0.8, 0.7),\n    roughness_R: parRoughR,\n"
        "    roughness_TT: float2(0.4),\n    roughness_TRT: float2(0.5, 0.6),\n"
        "    cuticle_angle: math::radians(parCuticle),\n"
        "    absorption_coefficient: color(1.001) - parAbsorptionColor,\n    ior: 1.6\n  )\n);\n"),
    "hair_plain_absorption": (
        "mdl 1.4;\nexport material m() = material(\n  hair: df::chiang_hair_bsdf(\n"
        "    absorption_coefficient: color(0.4, 0.7, 1.3),\n    cuticle_angle: 0.07\n  )\n);\n"),
    # volumes
    "volume": surface(
        "scattering: df::specular_bsdf(mode: df::scatter_reflect_transmit)",
        extra=",\n  ior: color(1.33),\n  volume: material_volume(\n"
              "    scattering: df::anisotropic_vdf(directional_bias: 0.45),\n"
              "    absorption_coefficient: (parDistanceScale <= 0) ? color(0) : "
              "math::log(parTransmittance + 1e-4) / -parDistanceScale,\n"
              "    scattering_coefficient: parScattering\n  )",
        params="uniform color parTransmittance = color(0.9, 0.5, 0.2), uniform float parDistanceScale = 2.0, "
               "uniform color parScattering = color(0.5, 0.4, 0.3)"),
    "volume_zero_scale": surface(
        "scattering: df::specular_bsdf(mode: df::scatter_transmit)",
        extra=",\n  volume: material_volume(\n    absorption_coefficient: math::log(parT + 0.01) / -parS\n  )",
        params="uniform color parT = color(0.5), uniform float parS = 0.0"),
    # emission forms
    "emission_exitance": surface(
        "emission: material_emission(\n      emission: df::diffuse_edf(),\n      intensity: color(10.0, 20.0, 30.0),\n"
        "      mode: intensity_radiant_exitance\n    )"),
    "emission_power_product": surface(
        f"scattering: {LEAF},\n    emission: material_emission(\n      emission: df::diffuse_edf(),\n"
        "      intensity: parTint * parScale,\n      mode: intensity_power\n    )",
        params="uniform color parTint = color(1.0, 0.5, 0.25), uniform float parScale = 40.0"),
    "emission_textured": surface(
        "emission: material_emission(\n      emission: df::diffuse_edf(),\n      intensity: tex.tint * parI,\n"
        "      mode: intensity_radiant_exitance\n    )",
        params='uniform texture_2d parTex = texture_2d("tex/emit.png", tex::gamma_linear), uniform float parI = 7.0',
        lets="    base::texture_return tex = base::file_texture(texture: parTex);"),
    # textures, uv placement and cutouts
    "albedo_texture": surface(
        "scattering: df::diffuse_reflection_bsdf(tint: tex.tint * color(0.5))",
        params='uniform texture_2d parTex = texture_2d("tex/albedo.png"), '
               "uniform float3 parRot = float3(0.0, 0.0, 30.0), uniform float3 parTrans = float3(0.1, 0.2, 0.0), "
               "uniform float3 parScale = float3(2.0, 3.0, 1.0)",
        lets="    base::texture_return tex = base::file_texture(texture: parTex, uvw: base::transform_coordinate("
             "transform: base::rotation_translation_scale(rotation: parRot, translation: parTrans, scaling: parScale)));"),
    "cutout_texture": surface(
        f"scattering: {LEAF}",
        extra=",\n  geometry: material_geometry(cutout_opacity: cut.mono)",
        params='uniform texture_2d parCut = texture_2d("tex/holes.png", tex::gamma_linear)',
        lets="    base::texture_return cut = base::file_texture(texture: parCut, mono_source: base::mono_average);"),
    "cutout_scalar": surface(f"scattering: {LEAF}", extra=",\n  geometry: material_geometry(cutout_opacity: 0.4)"),
}

# load_material's other outcomes
PARSE_ERROR = surface("scattering: df::diffuse_reflection_bsdf(tint: noise.tint)",
                      lets="    base::texture_return noise = base::perlin_noise_texture(noise_levels: 1e400);")


def write_files(directory: str) -> None:
    """The ``.mdl`` files of ``MDL`` under ``directory/mdl``, and the
    textures and measurement they name."""
    os.makedirs(os.path.join(directory, "mdl", "tex"), exist_ok=True)
    os.makedirs(os.path.join(directory, "mdl", "meas"), exist_ok=True)
    for name, text in dict(MDL, parse_error=PARSE_ERROR).items():
        with open(os.path.join(directory, "mdl", f"{name}.mdl"), "w") as f:
            f.write(text)
    rng = np.random.default_rng(16)
    for tex in ("albedo", "emit", "holes"):
        write_png(os.path.join(directory, "mdl", "tex", f"{tex}.png"), rng.integers(0, 256, (8, 16, 3), np.uint8))
    np.savez(os.path.join(directory, "mdl", "meas", "ggx.npz"), reflection=bake_ggx(alpha=0.3, res_theta=8,
                                                                                       res_phi=16).reflection)


def same_material(a, b) -> None:
    """Every field equal, with the same Python types (enums by value)."""
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x == y, (a.name, f.name, x, y)
        assert type(x).__name__ == type(y).__name__, (a.name, f.name, type(x), type(y))


def assert_tables_equal(table, jtable) -> None:
    """Two ``MaterialTable``s: every column, the atlas' and the measurement
    stack's arrays, bit for bit."""
    for f in dataclasses.fields(table):
        if f.name == "measurements":  # the port's cache of the loaded files
            continue
        a, b = getattr(table, f.name), getattr(jtable, f.name)
        if f.name in ("atlas", "mbsdf"):
            if a is None or b is None:
                assert a is None and b is None, f.name
                continue
            a, b = (a.device_arrays(), b.device_arrays()) if f.name == "atlas" else (vars(a), vars(b))
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f.name


@pytest.fixture(scope="module")
def mdl_dir(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("mdl"))
    write_files(directory)
    return directory


@pytest.mark.parametrize("name", sorted(MDL))
def test_parse_mdl_material_equals_jax(mdl_dir, name):
    path = os.path.join(mdl_dir, "mdl", f"{name}.mdl")
    got, ref = PMDL.parse_mdl_material(path, name), JMDL.parse_mdl_material(path, name)
    same_material(got, ref)
    assert PMDL.parse_mdl_material(path).name == JMDL.parse_mdl_material(path).name == name


def test_forms_reach_their_branches(mdl_dir):
    """The files above reach what they are named for."""
    A = PM.Archetype
    m = {name: PMDL.parse_mdl_material(os.path.join(mdl_dir, "mdl", f"{name}.mdl"), name) for name in MDL}
    assert m["specular_reflect_transmit"].archetype == A.SPECULAR_REFLECT_TRANSMIT and m["specular_reflect_transmit"].ior == 1.7
    assert m["ggx_reflect_transmit"].archetype == A.GGX_REFLECT_TRANSMIT and m["null_bsdf"].archetype == A.NULL_BSDF
    assert m["thin_walled_param"].thin_walled and m["diffuse_params"].albedo == (0.25, 0.5, 0.75)
    assert m["fresnel_layer"].blend_mode == 2 and m["measured_curve_layer"].blend_mode == 3
    assert len(m["custom_curve_layer"].curve_values) == PM.CURVE_RES
    assert m["normalized_mix"].archetype2 == A.DIFFUSE_REFLECTION and m["tint"].albedo == (0.35, 0.15, 0.5)
    assert [m[k].mod_mode for k in ("directional_factor", "fresnel_factor", "thin_film", "measured_curve_factor")] == [1, 2, 3, 4]
    assert (m["noise_perlin"].noise_mode, m["noise_perlin"].noise_levels, m["noise_perlin"].noise_marble) == (1, 5, True)
    assert m["noise_worley_bump"].noise_bump_factor == 0.4 and m["noise_worley_bump"].noise_target == 1
    assert m["measured_param"].archetype == A.MEASURED and m["measured_param"].mbsdf_multiplier == 1.25
    assert m["hair"].archetype == A.HAIR and m["hair"].hair_roughness[0] == (0.15, 0.25)
    assert m["volume"].sigma_s == (0.5, 0.4, 0.3) and m["volume"].volume_bias == 0.45
    assert m["volume_zero_scale"].sigma_a == (0.0, 0.0, 0.0)
    assert m["emission_power_product"].emission_intensity == (40.0, 20.0, 10.0)
    assert m["emission_textured"].emission_tex_path.endswith("emit.png") and not m["emission_textured"].emission_tex_srgb
    assert m["albedo_texture"].uv_scale == (2.0, 3.0) and m["cutout_texture"].cutout_tex_path.endswith("holes.png")
    assert m["cutout_scalar"].cutout_opacity == 0.4


def test_material_tables_equal_jax(mdl_dir):
    """Every row of the file set in one table: both packages'
    ``MaterialTable.build`` (textures decoded, the measurement loaded)
    give the same arrays."""
    rows = [PMDL.parse_mdl_material(os.path.join(mdl_dir, "mdl", f"{n}.mdl"), n) for n in sorted(MDL)]
    jrows = [JMDL.parse_mdl_material(os.path.join(mdl_dir, "mdl", f"{n}.mdl"), n) for n in sorted(MDL)]
    assert_tables_equal(PM.MaterialTable.build(rows), JM.MaterialTable.build(jrows))


def test_load_material_and_report_equal_jax(mdl_dir, monkeypatch):
    """Resolution on the search paths (then ``""``), and each outcome's
    report entry: ok, not_found, parse_error; the fallback is a gray
    diffuse material of the declared name."""
    monkeypatch.chdir(mdl_dir)
    search = (os.path.join(mdl_dir, "nowhere"), os.path.join(mdl_dir, "mdl"))
    cases = [(search, "ggx_reflect.mdl", "a"), (search, "missing.mdl", "b"), (search, "parse_error.mdl", "c"),
             ((), "mdl/hair.mdl", "d"), (("",), "mdl/volume.mdl", "e"), (search, "tex", "f")]
    report, jreport = [], []
    for paths, rel, name in cases:
        got = PMDL.load_material(paths, rel, name, report=report)
        ref = JMDL.load_material(paths, rel, name, report=jreport)
        same_material(got, ref)
        same_material(PMDL.load_material(paths, rel, name), JMDL.load_material(paths, rel, name))
    assert report == jreport
    assert [e["status"].split(":")[0] for e in report] == ["ok", "not_found", "parse_error", "ok", "ok", "not_found"]
    assert report[2]["status"] == "parse_error: OverflowError: cannot convert float infinity to integer"
    assert report[1]["fallback"] == "gray diffuse" and report[1]["resolved"] is None
