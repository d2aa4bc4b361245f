"""Mini-MDL reader: maps the reference's ``data/mdl/*.mdl`` files to archetypes.

The port's copy of ``nrc_tpu/scene/mdl.py`` (pure Python and NumPy; the
blend, modifier and noise constants come from the port's
``ops/layered.py`` and ``ops/noise.py``), so that a file gives the same
``Material`` row and the same load report in both packages.

The reference runs the full NVIDIA MDL SDK compiler (``Raytracer.cpp:1458-2536``)
to JIT each material to PTX. The parametric material system (``materials.py``)
needs no codegen: this module reads the small declarative subset of MDL
the sample scenes use (a df:: BSDF or a two-lobe layer / mix / modifier
graph, measured and hair BSDFs, procedural noise, emission, volume
coefficients, textures and parameter defaults) and produces a ``Material``
row.

Unknown/unsupported MDL constructs degrade to a diffuse material so
arbitrary scenes still load; ``load_material``'s report says so.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops import layered as LY
from ..ops.noise import NOISE_FLOW, NOISE_PERLIN, NOISE_WORLEY
from .materials import CURVE_RES, Archetype, EmissionMode, Material

_NUM = r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?"


def _parse_params(text: str) -> Dict[str, object]:
    """Extract ``uniform <type> name = default`` parameter defaults."""
    params: Dict[str, object] = {}
    # color(...) defaults
    for m in re.finditer(
        rf"(?:uniform\s+)?color\s+(\w+)\s*=\s*color\(\s*({_NUM})(?:\s*,\s*({_NUM})\s*,\s*({_NUM}))?\s*\)",
        text,
    ):
        name = m.group(1)
        if m.group(3) is not None:
            params[name] = (float(m.group(2)), float(m.group(3)), float(m.group(4)))
        else:
            v = float(m.group(2))
            params[name] = (v, v, v)
    # color defaults written as a bare scalar (color parW = 0.5)
    for m in re.finditer(
        rf"(?:uniform\s+)?color\s+(\w+)\s*=\s*({_NUM})\s*[,\)\[]", text
    ):
        params.setdefault(m.group(1), (float(m.group(2)),) * 3)
    # float2 defaults (e.g. per-lobe hair roughness)
    for m in re.finditer(
        rf"(?:uniform\s+)?float2\s+(\w+)\s*=\s*float2\(\s*({_NUM})(?:\s*,\s*({_NUM}))?\s*\)",
        text,
    ):
        a = float(m.group(2))
        b = float(m.group(3)) if m.group(3) is not None else a
        params[m.group(1)] = (a, b)
    # float defaults
    for m in re.finditer(rf"(?:uniform\s+)?float\s+(\w+)\s*=\s*({_NUM})", text):
        params.setdefault(m.group(1), float(m.group(2)))
    # bool defaults
    for m in re.finditer(r"(?:uniform\s+)?bool\s+(\w+)\s*=\s*(true|false)", text):
        params.setdefault(m.group(1), m.group(2) == "true")
    return params


def _resolve_color(expr: str, params: Dict[str, object]) -> Tuple[float, float, float]:
    expr = expr.strip()
    m = re.match(rf"color\(\s*({_NUM})\s*,\s*({_NUM})\s*,\s*({_NUM})\s*\)", expr)
    if m:
        return (float(m.group(1)), float(m.group(2)), float(m.group(3)))
    m = re.match(rf"color\(\s*({_NUM})\s*\)", expr)
    if m:
        v = float(m.group(1))
        return (v, v, v)
    if expr in params:
        v = params[expr]
        if isinstance(v, tuple):
            return v
        return (float(v),) * 3
    m = re.match(r"color\(\s*(\w+)\s*,\s*(\w+)\s*,\s*(\w+)\s*\)", expr)
    if m:
        return tuple(_resolve_float(m.group(i), params, 1.0) for i in (1, 2, 3))
    m = re.match(r"color\(\s*(\w+)\s*\)", expr)
    if m:
        return (_resolve_float(m.group(1), params, 1.0),) * 3
    return (1.0, 1.0, 1.0)


def _resolve_float(expr: str, params: Dict[str, object], default: float) -> float:
    expr = expr.strip()
    m = re.match(rf"^({_NUM})$", expr)
    if m:
        return float(m.group(1))
    if expr in params and isinstance(params[expr], float):
        return float(params[expr])  # type: ignore[arg-type]
    return default


def _resolve_volume_coeff(
    expr: str, params: Dict[str, object]
) -> Tuple[float, float, float]:
    """Volume coefficient expressions.

    The sample materials express coefficients via a target transmittance
    color at a distance scale (``data/mdl/vdf_anisotropic.mdl``):
    ``(scale <= 0) ? color(0) : math::log(X + eps) / -scale``
    which is sigma = -log(X + eps)/scale per channel. Evaluate that pattern
    numerically; anything else falls back to direct color resolution.
    """
    m = re.search(
        rf"math::log\(\s*(\w+)\s*\+\s*({_NUM})\s*\)\s*/\s*-\s*(\w+)", expr
    )
    if m:
        base = _resolve_color(m.group(1), params)
        eps = float(m.group(2))
        scale = _resolve_float(m.group(3), params, 1.0)
        if scale <= 0.0:
            return (0.0, 0.0, 0.0)
        import math

        return tuple(max(0.0, -math.log(v + eps) / scale) for v in base)
    return _resolve_color(expr, params)


def _balanced(text: str, i: int) -> tuple[str, int]:
    """Return (args, close_idx) of the paren group opening at text[i]=='('."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "(":
            depth += 1
        elif text[j] == ")":
            depth -= 1
            if depth == 0:
                return text[i + 1 : j], j
    return text[i + 1 :], len(text)


def _find_df_call(text: str, anchor: str, start: int = 0):
    """Find ``<anchor> df::name( ... )`` with balanced parens.

    Returns (name, args, end_idx) or None."""
    m = re.compile(anchor + r"\s*df::(\w+)\s*\(").search(text, start)
    if not m:
        return None
    args, end = _balanced(text, m.end() - 1)
    return m.group(1), args, end


def _parse_leaf_bsdf(bsdf_name: str, args: str, params):
    """One elemental df::*_bsdf call -> (archetype, albedo, roughness)."""
    mode_m = re.search(r"mode\s*:\s*(?:df::)?(\w+)", args)
    mode = mode_m.group(1) if mode_m else "scatter_reflect"
    arch = _bsdf_archetype(bsdf_name, mode)
    albedo = (1.0, 1.0, 1.0)
    # value may be a call like color(r, g, b) — allow one paren level
    tm = re.search(r"tint\s*:\s*((?:[^,()\n]|\([^()]*\))+)", args)
    if tm:
        albedo = _resolve_color(tm.group(1), params)
    ru = re.search(r"roughness_u\s*:\s*([^,\n)]+)", args)
    rv = re.search(r"roughness_v\s*:\s*([^,\n)]+)", args)
    u = _resolve_float(ru.group(1), params, 0.0) if ru else 0.0
    v = _resolve_float(rv.group(1), params, 0.0) if rv else u
    return arch, albedo, (u, v)


# MDL BSDF combinators normalized to the two-lobe blend family
# (ops/layered.py). Keys = df:: node names in the sample materials.
_COMBINATORS = {
    "weighted_layer", "color_weighted_layer",
    "fresnel_layer", "color_fresnel_layer",
    "measured_curve_layer", "color_measured_curve_layer",
    "custom_curve_layer", "color_custom_curve_layer",
    "normalized_mix", "clamped_mix", "unbounded_mix",
    "color_normalized_mix", "color_clamped_mix", "color_unbounded_mix",
    "tint", "directional_factor", "fresnel_factor", "thin_film",
    "measured_curve_factor",
}


def _parse_curve_values(args: str, params) -> tuple:
    """color[](color(...), ...) array literal -> tuple of rgb tuples."""
    m = re.search(r"curve_values\s*:\s*color\[\]\s*\(", args)
    if not m:
        return ()
    body, _ = _balanced(args, m.end() - 1)
    vals = []
    for cm in re.finditer(
        rf"color\(\s*({_NUM})\s*,\s*({_NUM})\s*,\s*({_NUM})\s*\)", body
    ):
        vals.append((float(cm.group(1)), float(cm.group(2)), float(cm.group(3))))
    return tuple(vals)


def _parse_combinator(mat: Material, root: str, args: str, params) -> None:
    """Normalize an MDL layer/mix/modifier graph into Material's two lobes
    + blend/modifier descriptor (lobe 1 = layer, lobe 2 = base)."""
    def top_expr(key):
        """Value expression of `key:` up to a depth-0 comma (so nested
        color(...)/math::exp(...) calls survive)."""
        m = re.search(rf"\b{key}\s*:\s*", args)
        if not m:
            return None
        depth = 0
        j = m.end()
        while j < len(args):
            c = args[j]
            if c == "(":
                depth += 1
            elif c == ")":
                if depth == 0:
                    break
                depth -= 1
            elif c in ",\n" and depth == 0:
                break
            j += 1
        return args[m.end() : j].strip()

    def sub_span(anchor):
        return _find_df_call(args, anchor)

    if root in ("tint",):
        # df::tint folds into the base lobe's albedo (linear in tint)
        sub = sub_span(r"base\s*:")
        t = _resolve_color(top_expr("tint") or "color(1.0)", params)
        if sub:
            arch, alb, rough = _parse_leaf_bsdf(sub[0], sub[1], params)
            mat.archetype, mat.roughness = arch, rough
            mat.albedo = tuple(a * b for a, b in zip(alb, t))
        return

    if root in ("directional_factor", "fresnel_factor", "thin_film",
                "measured_curve_factor"):
        sub = sub_span(r"base\s*:")
        if sub:
            arch, alb, rough = _parse_leaf_bsdf(sub[0], sub[1], params)
            mat.archetype, mat.albedo, mat.roughness = arch, alb, rough
        if root == "directional_factor":
            mat.mod_mode = LY.MOD_DIRECTIONAL
            mat.mod_a = _resolve_color(top_expr("normal_tint") or "color(1)", params)
            mat.mod_b = _resolve_color(top_expr("grazing_tint") or "color(1)", params)
            mat.mod_exp = _resolve_float(top_expr("exponent") or "1", params, 1.0)
        elif root == "fresnel_factor":
            mat.mod_mode = LY.MOD_FRESNEL_COND
            mat.mod_a = _resolve_color(top_expr("ior") or "color(1.5)", params)
            ext = top_expr("extinction_coefficient") or "color(0)"
            # sample file computes extinction = exp(-par) inline
            em = re.search(
                r"math::exp\(float3\(\s*-(\w+)\s*,\s*-(\w+)\s*,\s*-(\w+)", ext
            )
            if em:
                import math as _math

                mat.mod_b = tuple(
                    _math.exp(-_resolve_float(em.group(i), params, 0.0))
                    for i in (1, 2, 3)
                )
            else:
                mat.mod_b = _resolve_color(ext, params)
        elif root == "thin_film":
            mat.mod_mode = LY.MOD_THIN_FILM
            mat.mod_a = _resolve_color(top_expr("ior") or "color(1.5)", params)
            mat.mod_exp = _resolve_float(top_expr("thickness") or "500", params, 500.0)
        else:  # measured_curve_factor
            mat.mod_mode = LY.MOD_CURVE
            mat.curve_values = _parse_curve_values(args, params)
        return

    if root.endswith("_mix"):
        # two df::bsdf_component(weight, component) entries
        comps = []
        pos = 0
        for _ in range(2):
            cm = re.compile(r"df::(?:color_)?bsdf_component\s*\(").search(args, pos)
            if not cm:
                break
            body, end = _balanced(args, cm.end() - 1)
            w = re.search(r"weight\s*:\s*([^,\n]+)", body)
            w_rgb = _resolve_color(w.group(1), params) if w else (1.0, 1.0, 1.0)
            sub = _find_df_call(body, r"component\s*:")
            if sub:
                comps.append((w_rgb, _parse_leaf_bsdf(sub[0], sub[1], params)))
            pos = end
        if not comps:
            return
        w1 = np.asarray(comps[0][0], np.float64)
        w2 = np.asarray(comps[1][0] if len(comps) > 1 else (0.0,) * 3, np.float64)
        if root.endswith("normalized_mix"):
            s = w1 + w2
            scale = np.where(s > 1.0, 1.0 / np.maximum(s, 1e-9), 1.0)
            w1, w2 = w1 * scale, w2 * scale
        elif root.endswith("clamped_mix"):
            w1 = np.minimum(w1, 1.0)
            w2 = np.minimum(w2, 1.0 - w1)
        mat.blend_mode = LY.BLEND_FIXED
        mat.blend_w1 = tuple(w1)
        mat.blend_w2 = tuple(w2)
        mat.archetype, mat.albedo, mat.roughness = comps[0][1]
        if len(comps) > 1:
            mat.archetype2, mat.albedo2, mat.roughness2 = comps[1][1]
        return

    # layer nodes: weight/ior/curve + layer + base
    layer = sub_span(r"layer\s*:")
    base = sub_span(r"base\s*:")
    w_expr = top_expr("weight") or "1.0"
    w_rgb = _resolve_color(w_expr, params)
    if layer:
        mat.archetype, mat.albedo, mat.roughness = _parse_leaf_bsdf(
            layer[0], layer[1], params
        )
    if base:
        mat.archetype2, mat.albedo2, mat.roughness2 = _parse_leaf_bsdf(
            base[0], base[1], params
        )
    if root.endswith("weighted_layer"):
        mat.blend_mode = LY.BLEND_FIXED
        mat.blend_w1 = w_rgb
        mat.blend_w2 = tuple(1.0 - w for w in w_rgb)
    elif root.endswith("fresnel_layer"):
        mat.blend_mode = LY.BLEND_FRESNEL
        mat.blend_w1 = w_rgb
        mat.blend_ior = _resolve_float(top_expr("ior") or "1.5", params, 1.5)
    elif root.endswith("measured_curve_layer"):
        mat.blend_mode = LY.BLEND_CURVE
        mat.blend_w1 = w_rgb
        mat.curve_values = _parse_curve_values(args, params)
    elif root.endswith("custom_curve_layer"):
        # Schlick curve baked to the sampled-curve grid:
        # w(theta) = r0 + (r90 - r0) * (1 - cos)^exponent
        mat.blend_mode = LY.BLEND_CURVE
        mat.blend_w1 = w_rgb
        r0 = _resolve_float(top_expr("normal_reflectivity") or "0.04", params, 0.04)
        r90 = _resolve_float(top_expr("grazing_reflectivity") or "1.0", params, 1.0)
        ex = _resolve_float(top_expr("exponent") or "5.0", params, 5.0)
        ths = np.linspace(0.0, np.pi / 2, CURVE_RES)
        vals = r0 + (r90 - r0) * (1.0 - np.cos(ths)) ** ex
        mat.curve_values = tuple((float(v),) * 3 for v in vals)


def _bsdf_archetype(bsdf_name: str, mode: str) -> Archetype:
    glossy = {
        "microfacet_ggx_smith_bsdf",
        "microfacet_ggx_vcavities_bsdf",
        "microfacet_beckmann_smith_bsdf",
        "microfacet_beckmann_vcavities_bsdf",
        "simple_glossy_bsdf",
        "ward_geisler_moroder_bsdf",
        "sheen_bsdf",
        "backscattering_glossy_reflection_bsdf",
    }
    if bsdf_name == "diffuse_reflection_bsdf":
        return Archetype.DIFFUSE_REFLECTION
    if bsdf_name == "diffuse_transmission_bsdf":
        return Archetype.DIFFUSE_TRANSMISSION
    if bsdf_name == "specular_bsdf":
        if "reflect_transmit" in mode:
            return Archetype.SPECULAR_REFLECT_TRANSMIT
        if "transmit" in mode:
            return Archetype.SPECULAR_TRANSMIT
        return Archetype.SPECULAR_REFLECT
    if bsdf_name in glossy:
        if "reflect_transmit" in mode:
            return Archetype.GGX_REFLECT_TRANSMIT
        if "transmit" in mode:
            return Archetype.GGX_TRANSMIT
        return Archetype.GGX_REFLECT
    return Archetype.DIFFUSE_REFLECTION


def parse_mdl_material(path: str, name: str = "") -> Material:
    """Parse one .mdl file into a Material row (best-effort subset)."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    # strip comments
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)

    params = _parse_params(text)
    mat = Material(name=name or os.path.splitext(os.path.basename(path))[0])

    # --- texture_2d parameters + base::file_texture let-bindings ---------
    # (bsdf_diffuse_reflection_tex.mdl, bsdf_diffuse_reflection_cutout.mdl,
    # edf_diffuse_tex.mdl: the texture flows into tint / cutout_opacity /
    # emission intensity through a let variable)
    tex_params = {}  # param name -> (abs path, srgb)
    for tm in re.finditer(
        r"texture_2d\s+(\w+)\s*=\s*texture_2d\(\s*\"([^\"]+)\"\s*"
        r"(?:,\s*tex::gamma_(\w+))?\s*\)",
        text,
    ):
        tpath = os.path.normpath(os.path.join(os.path.dirname(path), tm.group(2)))
        tex_params[tm.group(1)] = (tpath, (tm.group(3) or "srgb") != "linear")
    ft_vars = {}  # let variable -> texture param name
    for fm in re.finditer(
        r"(\w+)\s*=\s*base::file_texture\(\s*texture:\s*(\w+)", text, re.S
    ):
        if fm.group(2) in tex_params:
            ft_vars[fm.group(1)] = fm.group(2)

    def _tex_of_expr(expr: str):
        """Texture bound to the first file_texture let-var in expr, if any."""
        for var, p in ft_vars.items():
            if re.search(rf"\b{var}\b", expr):
                return tex_params[p]
        return None

    # uv placement: rotation_translation_scale float3 parameter defaults
    def _float3(pname_expr: str, default=(0.0, 0.0, 0.0)):
        mm = re.search(
            rf"float3\s+{pname_expr}\s*=\s*float3\(\s*({_NUM})"
            rf"(?:\s*,\s*({_NUM})\s*,\s*({_NUM}))?\s*\)",
            text,
        )
        if not mm:
            return default
        a = float(mm.group(1))
        if mm.group(2) is None:
            return (a, a, a)
        return (a, float(mm.group(2)), float(mm.group(3)))

    if tex_params:
        rts = re.search(
            r"rotation_translation_scale\(\s*rotation:\s*(\w+)\s*,"
            r"\s*translation:\s*(\w+)\s*,\s*scaling:\s*(\w+)",
            text,
        )
        if rts:
            rot = _float3(rts.group(1))
            trans = _float3(rts.group(2))
            scale = _float3(rts.group(3), (1.0, 1.0, 1.0))
            mat.uv_rotation_z = rot[2]
            mat.uv_translation = (trans[0], trans[1])
            mat.uv_scale = (scale[0], scale[1])

    # --- procedural noise tint (base::perlin/flow/worley_noise_texture
    # feeding a diffuse tint — data/mdl/noise_*_glossy.mdl; the reference
    # JIT-compiles the MDL base module's noise, we evaluate an equivalent
    # field at shade time in ops/noise.py). The *_noise_bump_texture
    # geometry normal remains a gap (PARITY.md).
    nz = re.search(r"base::(perlin|flow|worley)_noise_texture\s*\(", text)
    if nz:
        nargs, _ = _balanced(text, nz.end() - 1)

        def narg(key, default=""):
            mm = re.search(rf"{key}\s*:\s*([^,\n]+)", nargs)
            return mm.group(1).strip() if mm else default

        mat.noise_mode = {
            "perlin": NOISE_PERLIN, "flow": NOISE_FLOW,
            "worley": NOISE_WORLEY,
        }[nz.group(1)]
        mat.noise_color1 = _resolve_color(narg("color1", "color(0)"), params)
        mat.noise_color2 = _resolve_color(narg("color2", "color(1)"), params)
        lv = narg("noise_levels") or narg("levels")
        mat.noise_levels = int(_resolve_float(lv, params, 3.0))
        ab = narg("absolute_noise", "false")
        mat.noise_absolute = (
            ab == "true" or bool(params.get(ab, False) is True)
        )
        mat.noise_thr_low = _resolve_float(
            narg("noise_threshold_low", "0"), params, 0.0
        )
        mat.noise_thr_high = _resolve_float(
            narg("noise_threshold_high", "1"), params, 1.0
        )
        mb = narg("apply_marble", "false")
        mat.noise_marble = (
            mb == "true" or bool(params.get(mb, False) is True)
        )
        rts_n = re.search(
            r"rotation_translation_scale\(\s*rotation:[^,]+,"
            r"\s*translation:[^,]+,\s*scaling:\s*(\w+)",
            nargs,
        ) or re.search(
            r"rotation_translation_scale\(\s*rotation:[^,]+,"
            r"\s*translation:[^,]+,\s*scaling:\s*(\w+)",
            text,
        )
        if rts_n:
            mat.noise_scale = _float3(rts_n.group(1), (1.0, 1.0, 1.0))
        # geometry-normal bump (base::*_noise_bump_texture factor)
        nb = re.search(r"_noise_bump_texture\s*\(", text)
        if nb:
            bargs, _ = _balanced(text, nb.end() - 1)
            fm = re.search(r"factor\s*:\s*([^,\n)]+)", bargs)
            mat.noise_bump_factor = _resolve_float(
                fm.group(1), params, 1.0
            ) if fm else 1.0

    # hair BSDF (material(hair: df::chiang_hair_bsdf(...)))
    hm = re.search(r"hair\s*:\s*df::chiang_hair_bsdf\s*\(([^;]*)\)", text, re.S)
    if hm:
        args = hm.group(1)
        mat.archetype = Archetype.HAIR

        def f2(name, default):
            mm = re.search(rf"{name}\s*:\s*([^,\n]+)", args)
            if not mm:
                return default
            expr = mm.group(1).strip()
            v = params.get(expr)
            if isinstance(v, tuple) and len(v) == 2:
                return v
            fm = re.match(rf"float2\(\s*({_NUM})(?:\s*,\s*({_NUM}))?\s*\)", expr)
            if fm:
                a = float(fm.group(1))
                return (a, float(fm.group(2)) if fm.group(2) else a)
            return default

        mat.hair_roughness = (
            f2("roughness_R", (0.1, 0.1)),
            f2("roughness_TT", (0.2, 0.2)),
            f2("roughness_TRT", (0.3, 0.3)),
        )
        mm = re.search(r"diffuse_reflection_weight\s*:\s*([^,\n]+)", args)
        if mm:
            mat.hair_diffuse_weight = _resolve_float(mm.group(1), params, 0.0)
        mm = re.search(r"diffuse_reflection_tint\s*:\s*([^,\n]+)", args)
        if mm:
            mat.albedo = _resolve_color(mm.group(1), params)
        mm = re.search(r"cuticle_angle\s*:\s*([^,\n]+)", args)
        if mm:
            expr = mm.group(1).strip()
            rm = re.match(r"math::radians\(\s*(\w+)\s*\)", expr)
            deg = _resolve_float(rm.group(1), params, 3.0) if rm else None
            mat.hair_cuticle_angle = (
                float(np.radians(deg)) if deg is not None
                else _resolve_float(expr, params, 0.0524)
            )
        # absorption: color(1.001) - parAbsorptionColor inversion
        mm = re.search(r"absorption_coefficient\s*:\s*([^,\n]+)", args)
        if mm:
            expr = mm.group(1).strip()
            im = re.match(rf"color\(\s*({_NUM})\s*\)\s*-\s*(\w+)", expr)
            if im:
                base = float(im.group(1))
                col = _resolve_color(im.group(2), params)
                mat.hair_absorption = tuple(max(base - c, 1e-4) for c in col)
            else:
                mat.hair_absorption = _resolve_color(expr, params)
        mm = re.search(r"\bior\s*:\s*([^,\n]+)", args)
        if mm:
            mat.ior = _resolve_float(mm.group(1), params, 1.55)
        return mat

    # measured BSDF (df::measured_bsdf(measurement: bsdf_measurement("p")))
    # -> data-driven archetype over scene/mbsdf.py tables. The measurement
    # may be inline or bound to a parameter / let variable. Balanced-paren
    # extraction — the inline bsdf_measurement("...") nests parentheses.
    comb = _find_df_call(text, r"scattering\s*:")
    if comb and comb[0] == "measured_bsdf":
        args = comb[1]
        meas_files = {
            v.group(1): v.group(2)
            for v in re.finditer(
                r"(\w+)\s*=\s*bsdf_measurement\(\s*\"([^\"]+)\"\s*\)", text
            )
        }
        fm = re.search(r"bsdf_measurement\(\s*\"([^\"]+)\"\s*\)", args)
        rel = fm.group(1) if fm else None
        if rel is None:
            vm = re.search(r"measurement\s*:\s*(\w+)", args)
            if vm and vm.group(1) in meas_files:
                rel = meas_files[vm.group(1)]
        if rel is not None:
            mat.archetype = Archetype.MEASURED
            mat.mbsdf_path = os.path.normpath(
                os.path.join(os.path.dirname(path), rel)
            )
            mult = re.search(r"multiplier\s*:\s*([^,\n)]+)", args)
            if mult:
                mat.mbsdf_multiplier = _resolve_float(mult.group(1), params, 1.0)
    is_measured = mat.archetype == Archetype.MEASURED

    # scattering combinator (layers/mixes/modifiers) -> two-lobe blend
    is_combinator = bool(
        not is_measured and comb and comb[0] in _COMBINATORS
    )
    if is_combinator:
        _parse_combinator(mat, comb[0], comb[1], params)
        m = None
    elif is_measured:
        m = None
    else:
        # elemental scattering BSDF (args may nest one call level, e.g.
        # tint: color(r, g, b))
        m = re.search(
            r"scattering\s*:\s*df::(\w+)\s*\(((?:[^()]|\([^()]*\))*)\)", text
        )
    if m:
        bsdf_name, args = m.group(1), m.group(2)
        mode_m = re.search(r"mode\s*:\s*(?:df::)?(\w+)", args)
        mode = mode_m.group(1) if mode_m else "scatter_reflect"
        mat.archetype = _bsdf_archetype(bsdf_name, mode)
        tint_m = re.search(r"tint\s*:\s*((?:[^,()\n]|\([^()]*\))+)", args)
        if tint_m:
            expr = tint_m.group(1)
            tex = _tex_of_expr(expr)
            if tex is not None:
                mat.albedo_tex_path, mat.albedo_tex_srgb = tex
                # drop the texture factor, resolve the remaining color term
                for var in ft_vars:
                    expr = re.sub(rf"\*?\s*\b{var}\b(\.\w+)?\s*\*?", "", expr)
                expr = expr.strip() or "color(1.0)"
            mat.albedo = _resolve_color(expr, params)
        elif "parDiffuseTint" in params or "parGlossyTint" in params or "parSpecularTint" in params:
            key = next(
                k for k in ("parDiffuseTint", "parGlossyTint", "parSpecularTint") if k in params
            )
            v = params[key]
            mat.albedo = v if isinstance(v, tuple) else (float(v),) * 3  # type: ignore[assignment]
        ru = re.search(r"roughness_u\s*:\s*([^,\n]+)", args)
        rv = re.search(r"roughness_v\s*:\s*([^,\n]+)", args)
        mat.roughness = (
            _resolve_float(ru.group(1), params, 0.1) if ru else mat.roughness[0],
            _resolve_float(rv.group(1), params, 0.1) if rv else mat.roughness[1],
        )
    elif not is_combinator and not is_measured:
        mat.archetype = Archetype.NULL_BSDF

    # material-level ior
    m = re.search(rf"^\s*ior\s*:\s*color\(\s*([^)]+?)\s*\)", text, flags=re.M)
    if m:
        mat.ior = _resolve_float(m.group(1), params, 1.5)

    # thin_walled
    m = re.search(r"thin_walled\s*:\s*(\w+)", text)
    if m:
        tw = params.get(m.group(1), m.group(1) == "true")
        mat.thin_walled = bool(tw)

    # emission
    m = re.search(r"intensity\s*:\s*([^,\n]+)", text)
    edf = re.search(r"emission\s*:\s*df::(\w+)", text)
    if edf and m:
        expr = m.group(1).strip()
        tex = _tex_of_expr(expr)
        if tex is not None:
            # textured EDF (edf_diffuse_tex.mdl): texture modulates at runtime
            mat.emission_tex_path, mat.emission_tex_srgb = tex
            for var in ft_vars:
                expr = re.sub(rf"\*?\s*\b{var}\b(\.\w+)?\s*\*?", "", expr)
            expr = expr.strip() or "1.0"
        # handle "tint * scalar" products
        prod = re.match(r"(\w+)\s*\*\s*(\w+)", expr)
        if prod:
            a = params.get(prod.group(1), 1.0)
            b = params.get(prod.group(2), 1.0)
            at = a if isinstance(a, tuple) else (float(a),) * 3
            bt = b if isinstance(b, tuple) else (float(b),) * 3
            mat.emission_intensity = tuple(x * y for x, y in zip(at, bt))  # type: ignore[assignment]
        else:
            mat.emission_intensity = _resolve_color(expr, params)
        mode_m = re.search(r"mode\s*:\s*intensity_(\w+)", text)
        mat.emission_mode = (
            EmissionMode.POWER
            if (mode_m and mode_m.group(1) == "power")
            else EmissionMode.RADIANT_EXITANCE
        )

    # volume absorption/scattering coefficients + HG phase anisotropy
    m = re.search(r"absorption_coefficient\s*:\s*([^,\n]+)", text)
    if m:
        mat.sigma_a = _resolve_volume_coeff(m.group(1), params)
    m = re.search(r"scattering_coefficient\s*:\s*([^,\n]+)", text)
    if m:
        mat.sigma_s = _resolve_volume_coeff(m.group(1), params)
    m = re.search(r"anisotropic_vdf\s*\(\s*directional_bias\s*:\s*([^,\n)]+)", text)
    if m:
        mat.volume_bias = _resolve_float(m.group(1), params, 0.0)

    # cutout: scalar, or a file_texture mono (bsdf_diffuse_reflection_cutout.mdl)
    m = re.search(r"cutout_opacity\s*:\s*([^,\n)]+)", text)
    if m and _tex_of_expr(m.group(1)) is not None:
        mat.cutout_tex_path, _ = _tex_of_expr(m.group(1))
        mat.cutout_opacity = 1.0
        m = None
    if m:
        mat.cutout_opacity = _resolve_float(m.group(1), params, 1.0)

    # procedural noise tint target: the shipped noise materials put the
    # noisy diffuse in the BASE of a fresnel/weighted layer — after the
    # combinator parse, lobe 2 holds that diffuse, so route the tint there
    if (
        mat.noise_mode
        and mat.archetype2 == Archetype.DIFFUSE_REFLECTION
        and mat.archetype != Archetype.DIFFUSE_REFLECTION
    ):
        mat.noise_target = 1

    return mat


def load_material(
    search_paths: tuple[str, ...], rel_path: str, name: str,
    report: Optional[list] = None,
) -> Material:
    """Resolve ``rel_path`` against search paths and parse; diffuse fallback.

    The fallback is LOUD, not silent: when ``report`` is given, one entry
    per material records what happened (resolved path, archetype chosen,
    or why it degraded to gray diffuse). The reference surfaces MDL compile
    errors through its message relay (``Raytracer.cpp:1655-1669``); the CLI
    prints this report's warnings the same way.
    """
    err: Optional[str] = None
    for sp in search_paths + ("",):
        p = os.path.join(sp, rel_path) if sp else rel_path
        if os.path.isfile(p):
            try:
                mat = parse_mdl_material(p, name)
                if report is not None:
                    report.append({
                        "reference": name, "path": rel_path,
                        "resolved": p, "status": "ok",
                        "archetype": mat.archetype.name,
                    })
                return mat
            except Exception as e:  # degrade, but say so
                err = f"parse_error: {type(e).__name__}: {e}"
                break
    if report is not None:
        report.append({
            "reference": name, "path": rel_path, "resolved": None,
            "status": err or "not_found",
            "archetype": Archetype.DIFFUSE_REFLECTION.name,
            "fallback": "gray diffuse",
        })
    return Material(name=name)
