"""Wavefront path tracer: the render and training wavefronts of one frame.

Port of ``nrc_tpu/render/integrator.py:131-1190`` (reference
``__raygen__nrc_path_tracer`` + ``__closesthit__radiance``,
``raygeneration.cu:139-289``, ``hit.cu:672-1064``). All rays advance together
one bounce at a time; every branch is a masked select, as in the JAX package,
so per-ray results agree with it. Per bounce: closest hit, emission with MIS,
area-spread truncation into the cache (paper Eq. 2-4, ``hit.cu:527-585``),
BSDF sampling (the IORs from the ray's nested-medium stack, pushed and
popped where a path transmits through a boundary), next-event estimation
with MIS and a shadow ray (optionally culled by shadow-ray Russian
roulette, ``FrameConfig.nee_rr_tau``), and the ``traced_count``
accounting.

The render wavefront (``train=False``) covers every pixel and stops a path
where its area spread outgrows the camera's footprint. The training
wavefront (``train=True``, one ray per screen tile) keeps going past that
vertex into a suffix and writes a training record at every non-specular
vertex into a per-ray slot array ``[N, D]`` (D =
``cfg.max_train_records_per_ray``); radiance found later is added to the
last record. A suffix ends on the cache (its end query, mask 1), or, for the
``unbiased`` rays, only by a miss, an absorb, Russian roulette or the
maximum depth (mask 0). Path Russian roulette exists only on that unbiased
suffix in the reference.

The JAX package splits large wavefronts into bands under ``lax.map``
(``trace_wavefront_chunked``); the outputs are per ray, so one pass over all
rays computes the same thing. Depth 0 of the render wavefront may arrive
resolved (``primary_hit``: the primary raster of ``ops/raster_primary.py``,
``frame_step``'s choice), in place of its first closest hit. On the CPU the
bounce loop stops when no ray is alive, like the JAX ``while_loop`` (a read
of a flag per bounce). On the card it runs all ``max_depth`` bounces, like
the JAX package's fixed-length scan (``NRC_BOUNCE_SCAN``), and reads
nothing back, so that a frame can be captured as a CUDA graph: a dead lane
traces an empty t range, which K1/K2 and W1/W2 answer without work, and
every update is masked by ``alive`` or ``hit_valid``, so the outputs are the
same bit for bit.

Declared lights and textures (``FrameConfig.has_textures`` /
``has_cutout``, set from the scene): an escaping ray takes the environment's
radiance with MIS against the BSDF pdf; a hit's albedo and emission are
multiplied by their textures' bilinear fetches at its texcoord; a textured
mesh light's EDF is fetched at the sampled point in NEE; a cutout surface
passes a ray through with probability 1 - opacity (the wavefront form of
``optixIgnoreIntersection`` in ``__anyhit__radiance_cutout``,
``hit.cu:1400-1423``): the lane keeps its direction, throughput and MIS
state, re-traces from the hit point at the next bounce and carries the
distance passed (``pass_dist``) into its area spread. A shadow ray through
cutouts takes three closest-hit hops, each blocked with probability =
opacity (``__anyhit__shadow_cutout``, ``hit.cu:1447-1468``), on uniforms
drawn before the hops; the JAX package's hops exit once every lane has
resolved, and a lane resolved early adds nothing to a later hop, so the
card runs all three and reads nothing back, and the result and the
``traced_count`` are the same. Each of these compiles in only when its
switch is on.

Materials and media (``has_layered``, ``has_measured``, ``has_noise``,
``has_noise_bump``, ``has_volumes``; ``nrc_tpu/render/integrator.py:
264-292, 334-362, 422-470, 503-596, 677-788, 868-887, 1040-1055``), each
again only under its switch:
- a procedural noise tint replaces the albedo of the lobe the material
  names (``noise_target``), and a noise bump moves the shading normal,
  both at the world hit position and before anything reads them
  (``ops/noise.py``);
- a layered material samples, evaluates and reports its aux as a two-lobe
  mixture with a modifier factor (``ops/layered.py``), on one more uniform
  a bounce that picks the lobe;
- a measured material (archetype ``MEASURED``) takes ``ops/mbsdf.py``'s
  lobe in sample, aux and NEE;
- homogeneous media ride the medium stack beside the IORs: absorption and
  scattering coefficients and the Henyey-Greenstein anisotropy of each
  level, pushed where a path transmits into a boundary. Inside a
  scattering medium a free-flight distance, drawn by channel importance,
  caps the closest hit's t range; a hit weighs its throughput by the
  transmittance over the probability of flying that far, and a flight that
  ends before any surface (``scatter_miss``) moves the ray to that point,
  weighs it by sigma_s T / pdf and turns it into a Henyey-Greenstein
  direction, keeping the previous event and pdf for MIS (``stepVolume``,
  ``miss.cu:62-79``). A medium with no scattering attenuates by
  Beer-Lambert alone. ``walk`` counts the steps and resets where the ray
  crosses a boundary; the walk stops stepping at ``cfg.walk_length``.

Each new uniform is drawn for every lane, live or not, in the JAX
package's order, so the stream stays bit for bit: the free flight's two
before the closest hit, the Henyey-Greenstein pair after the cutout's,
the lobe pick after the BSDF's four.

Curves and hair (``nrc_tpu/render/integrator.py:161-166, 371-412, 478-487,
714-800, 888-893, 1012-1016``), compiled in only where the device scene
has curve segments (``DeviceScene.curves``, as the JAX package's
``has_curves``): a second closest-hit stream over the curve BVH (C1 on the
card) runs on the same rays after the triangles', and a curve hit wins
where its t is the smaller. On a curve hit the round cone's normal stands
for both normals and the segment's material for the triangle's, from one
row gather of the packed curve rows a bounce (K7); it takes no texture and
no cutout. A hair material (``HAIR``) on a curve hit samples, evaluates
and reports its aux with the Chiang BSDF (``ops/hair_bsdf.py``) in the
fibre frame (tangent and the strand's azimuthal basis), on the bounce's
four uniforms (no new draw), with the azimuthal offset h from the normal
across the ray; a hair material on a triangle absorbs. Every shadow ray
is also tested against the curves (C2 on the card) after the triangles.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import FrameConfig, RenderMode
from ..ops import bsdf as B
from ..ops import curve_intersect as CI
from ..ops import hair_bsdf as H
from ..ops import layered as LY
from ..ops import mbsdf as MB
from ..ops import noise as NZ
from ..ops.gather_cuda import gather_rows
from ..ops.intersect import RT_MAX, Hit, make_intersectors
from ..ops.light_sampling import env_radiance, sample_lights
from ..ops.texture import apply_uv_transform, sample_bilinear
from ..scene.materials import Archetype
from ..utils import rng as R
from ..utils.math import (
    add1,
    balance_heuristic,
    build_onb,
    cartesian_to_spherical_unit,
    cross,
    dot,
    normalize,
    pick1,
    put1,
    safe_div,
    to_world,
)
from .scene_device import DeviceScene, mat_row_layout

QUERY_DIMS = 15  # pos3 + dir2 + normal2 + rough2 + diffuse3 + specular3

IOR_STACK_DEPTH = 4  # nested media (per_ray_data.h:81)


def make_query(pos, wo, normal, aux: B.BSDFAux, position_scale: float) -> torch.Tensor:
    """Assemble the compact radiance query (``nrc::addQuery``, hit.cu:589-617)."""
    return torch.cat(
        [
            pos * position_scale,
            cartesian_to_spherical_unit(wo),
            cartesian_to_spherical_unit(normal),
            aux.roughness,
            aux.albedo_diffuse,
            aux.albedo_glossy,
        ],
        dim=-1,
    )


class WavefrontOut(NamedTuple):
    """Per-ray outputs of a wavefront (N = #rays). The record fields are
    None for the render wavefront."""

    radiance: torch.Tensor                # [N, 3] path-traced radiance
    bounce_count: torch.Tensor            # [N] i64 surface hits
    traced_count: torch.Tensor            # [N] i64 rays actually cast: closest-hit
    #   segments of live lanes + shadow rays with a valid light sample
    render_query: torch.Tensor            # [N, 15] query at the truncation vertex
    last_render_throughput: torch.Tensor  # [N, 3] (0 -> query unused)
    cache_vis_query: torch.Tensor         # [N, 15] first non-specular vertex
    rec_query: Optional[torch.Tensor] = None   # [N, D, 15] training records
    rec_ltp: Optional[torch.Tensor] = None     # [N, D, 3] localThroughput
    rec_target: Optional[torch.Tensor] = None  # [N, D, 3] radiance found after
    rec_count: Optional[torch.Tensor] = None   # [N] i64 records written
    end_query: Optional[torch.Tensor] = None   # [N, 15] suffix end vertex
    end_mask: Optional[torch.Tensor] = None    # [N] 1 self-train end / 0 unbiased


class _State(NamedTuple):
    pos: torch.Tensor
    wi: torch.Tensor
    seed: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    pdf: torch.Tensor            # pdf of the previous BSDF event (0 = dirac)
    event: torch.Tensor          # previous event bitmask
    alive: torch.Tensor
    hit_before: torch.Tensor     # apply the scene epsilon (raygeneration.cu:175)
    area_spread: torch.Tensor
    area_threshold: torch.Tensor
    recorded_first: torch.Tensor
    render_done: torch.Tensor    # the render part of the path has terminated
    ior_stack: torch.Tensor      # [N, 4] nested-medium IORs (per_ray_data.h:81)
    stack_idx: torch.Tensor      # [N] i64 the stack's top
    bounces: torch.Tensor
    traced: torch.Tensor
    last_render_throughput: torch.Tensor
    render_query: torch.Tensor
    cache_vis_query: torch.Tensor
    # distance passed through cutouts since the last real hit (has_cutout only)
    pass_dist: Optional[torch.Tensor] = None
    # the media of the stack's levels and the walk's steps (has_volumes only)
    sigma_a_stack: Optional[torch.Tensor] = None  # [N, 4, 3] absorption
    sigma_s_stack: Optional[torch.Tensor] = None  # [N, 4, 3] scattering
    bias_stack: Optional[torch.Tensor] = None     # [N, 4] HG anisotropy g
    walk: Optional[torch.Tensor] = None           # [N] i64 volume steps taken
    # training wavefront only (None in the render wavefront)
    suffix: Optional[torch.Tensor] = None     # in the training suffix
    unbiased: Optional[torch.Tensor] = None   # suffix ends only unbiased
    full: Optional[torch.Tensor] = None       # record slots exhausted
    rec_count: Optional[torch.Tensor] = None
    rec_query: Optional[torch.Tensor] = None
    rec_ltp: Optional[torch.Tensor] = None
    rec_target: Optional[torch.Tensor] = None
    end_query: Optional[torch.Tensor] = None
    end_mask: Optional[torch.Tensor] = None


def _all_done(alive: torch.Tensor) -> bool:
    """The bounce loop's early exit: no ray is alive. A read of the device,
    so only off the card; on a CUDA tensor it is never done."""
    return alive.device.type != "cuda" and not bool(alive.any())


def trace_wavefront(
    scene: DeviceScene,
    org: torch.Tensor,        # [N, 3] primary ray origins
    direction: torch.Tensor,  # [N, 3]
    seeds: torch.Tensor,      # [N] i64 (after lens-jitter consumption)
    cfg: FrameConfig,
    train: bool = False,
    unbiased: Optional[torch.Tensor] = None,  # [N] bool, training wavefront
    primary_hit: Optional[Hit] = None,  # depth 0's hit, resolved before (the primary raster)
    spans=None,  # utils/spans.py::SpanRecorder: a stamp and the live lanes at each bounce
) -> WavefrontOut:
    n = org.shape[0]
    dev = org.device
    closest_hit, any_hit = make_intersectors(scene.tris, scene.planes, scene.bvh)
    lights = scene.lights
    num_lights = lights.num
    d_rec = cfg.max_train_records_per_ray
    truncate = train or cfg.render_mode != RenderMode.NO_CACHE
    direct_lighting = cfg.direct_lighting and num_lights > 0
    eps = cfg.scene_epsilon
    sqrt_c = cfg.area_spread_sqrt  # sqrt(c), paper Eq. 4; default c = 0.01
    # the medium stack, only where an archetype of the scene transmits (the
    # JAX program computes it always and XLA drops what nothing reads); a
    # measurement may have a transmission part
    transmissive = B.transmits(
        cfg.archetype_set, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT,
        Archetype.SPECULAR_TRANSMIT, Archetype.SPECULAR_REFLECT_TRANSMIT, Archetype.DIFFUSE_TRANSMISSION,
        Archetype.MEASURED,
    )
    offs, _ = mat_row_layout(scene.mat_curve_k)
    has_tex, has_cutout = cfg.has_textures, cfg.has_cutout
    has_volumes, has_layered, has_measured = cfg.has_volumes, cfg.has_layered, cfg.has_measured
    # the curve stream and the hair lobe, only where the scene has curves
    has_curves = scene.curves is not None

    def mcol(row, name):
        a, b = offs[name]
        return row[:, a] if b == a + 1 else row[:, a:b]

    def tex_id(row, name):
        return mcol(row, name).to(torch.int64)

    def bary_uv(uvp, bu, bv):
        """The texcoord at barycentrics (bu, bv) from a row's uv0|uv1|uv2."""
        return ((1.0 - bu - bv)[:, None] * uvp[:, 0:2] + bu[:, None] * uvp[:, 2:4]
                + bv[:, None] * uvp[:, 4:6])

    def cutout_opacity_at(prim, bu, bv):
        """cutout_opacity x the cutout texture's RGB mean at a shadow hop's
        hit: one triangle row gather and one material row gather."""
        tsr = gather_rows(scene.tri_shade, prim)
        row = gather_rows(scene.mat_row, tsr[:, 24:26].view(torch.int32)[:, 0].to(torch.int64))
        uv = apply_uv_transform(bary_uv(tsr[:, 18:24], bu, bv), mcol(row, "uv_xf"))
        rgba = sample_bilinear(scene.atlas, tex_id(row, "cutout_tex"), uv)
        return mcol(row, "cutout_opacity") * rgba[:, :3].mean(dim=-1)

    # textured mesh-light EDFs sampled by NEE: (atlas, [L, 7] rows)
    nee_tex_ctx = (scene.atlas, scene.nee_tex) if has_tex and num_lights else None

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n,) + shape, dtype=dtype, device=dev)

    def full(value, dtype=torch.float32):
        return torch.full((n,), value, dtype=dtype, device=dev)

    false = zeros(dtype=torch.bool)
    state = _State(
        pos=org,
        wi=direction,
        seed=seeds,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        radiance=zeros(3),
        pdf=zeros(),
        event=full(B.BSDF_EVENT_ABSORB, torch.int64),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        hit_before=false,
        area_spread=zeros(),
        area_threshold=full(math.inf),
        recorded_first=false,
        render_done=false,
        ior_stack=torch.ones((n, IOR_STACK_DEPTH), dtype=torch.float32, device=dev),
        stack_idx=zeros(dtype=torch.int64),
        bounces=zeros(dtype=torch.int64),
        traced=zeros(dtype=torch.int64),
        last_render_throughput=zeros(3),
        render_query=zeros(QUERY_DIMS),
        cache_vis_query=zeros(QUERY_DIMS),
        pass_dist=zeros() if has_cutout else None,
    )
    if has_volumes:
        state = state._replace(
            sigma_a_stack=zeros(IOR_STACK_DEPTH, 3),
            sigma_s_stack=zeros(IOR_STACK_DEPTH, 3),
            bias_stack=zeros(IOR_STACK_DEPTH),
            walk=zeros(dtype=torch.int64),
        )
    if train:
        state = state._replace(
            suffix=false,
            unbiased=false if unbiased is None else unbiased,
            full=false,
            rec_count=zeros(dtype=torch.int64),
            rec_query=zeros(d_rec, QUERY_DIMS),
            rec_ltp=zeros(d_rec, 3),
            rec_target=zeros(d_rec, 3),
            end_query=zeros(QUERY_DIMS),
            end_mask=zeros(),
        )

    def add_to_last_record(s: _State, amount, mask) -> _State:
        """targets[lastTrainRecordIndex] += amount (miss.cu:144-147, hit.cu:817)."""
        if not train:
            return s
        slot = torch.clamp(s.rec_count - 1, min=0)
        m = mask & (s.rec_count > 0) & ~s.full
        return s._replace(rec_target=add1(s.rec_target, slot, amount, m))

    def bounce(s: _State, first: bool, depth: int) -> _State:
        active = s.alive
        wo = -s.wi
        tmin = torch.where(s.hit_before, eps, 0.0)
        # inactive lanes trace a degenerate ray (empty t range)
        tmax = torch.where(active, RT_MAX, 0.0)
        seed = s.seed

        # ---- volume random walk: the free-flight distance (raygeneration.
        # cu:184-213): inside a scattering medium the distance, drawn by
        # channel importance, caps the closest hit's t range
        if has_volumes:
            top_ss = pick1(s.sigma_s_stack, s.stack_idx)
            sigma_t = pick1(s.sigma_a_stack, s.stack_idx) + top_ss
            scattering = (s.stack_idx > 0) & (top_ss.amax(dim=-1) > 0.0)
            can_step = scattering & active & (s.walk < cfg.walk_length)
            seed, xi_w = R.rng2(seed)
            wgt = s.throughput * safe_div(top_ss, sigma_t)
            wsum = wgt.sum(dim=-1)
            pdf_volume = torch.where((wsum > 0.0)[:, None], wgt / torch.clamp(wsum, min=1e-20)[:, None], 1.0 / 3.0)
            cdf0 = pdf_volume[:, 0]
            cdf1 = cdf0 + pdf_volume[:, 1]
            s_chan = torch.where(xi_w[:, 0] < cdf0, sigma_t[:, 0],
                                 torch.where(xi_w[:, 0] < cdf1, sigma_t[:, 1], sigma_t[:, 2]))
            dist_sample = -torch.log(torch.clamp(1.0 - xi_w[:, 1], min=1e-12)) / torch.clamp(s_chan, min=1e-12)
            tmax = torch.where(can_step, torch.minimum(tmax, dist_sample), tmax)

        # depth 0 of the render wavefront may come resolved by the primary
        # raster (ops/raster_primary.py; tmin 0 and tmax RT_MAX there, no
        # medium before the first hit); the curve stream, cutout and media
        # follow as for the walk's hit
        hit = primary_hit if first and primary_hit is not None else closest_hit(s.pos, s.wi, tmin, tmax)
        if has_curves:
            # the curve stream on the same rays: a curve hit wins where its t
            # is below the triangle's
            c_hit = CI.intersect_curves_bvh(s.pos, s.wi, scene.curve_bvh, tmin, tmax)
            tri_t = torch.where(hit.valid, hit.t, RT_MAX)
            is_curve = c_hit.valid & (torch.where(c_hit.valid, c_hit.t, RT_MAX) < tri_t)
            hit = hit._replace(t=torch.where(is_curve, c_hit.t, hit.t))
            any_valid = hit.valid | is_curve
            hit_valid = any_valid & active
        else:
            hit_valid = hit.valid & active
        tri = torch.clamp(hit.prim, min=0)
        w_bary = 1.0 - hit.u - hit.v
        p_hit = s.pos + hit.t[:, None] * s.wi
        # ONE triangle row gather for all the hit's triangle-side inputs
        tsr = gather_rows(scene.tri_shade, tri)          # [N, 26]
        ng = normalize(cross(tsr[:, 3:6], tsr[:, 6:9]))
        ns = normalize(
            w_bary[:, None] * tsr[:, 9:12]
            + hit.u[:, None] * tsr[:, 12:15]
            + hit.v[:, None] * tsr[:, 15:18]
        )
        meta = tsr[:, 24:26].view(torch.int32).to(torch.int64)  # bit-cast columns
        mid, tri_light_id = meta[:, 0], meta[:, 1]
        if has_curves:
            # the round cone's frame and the segment's material: one row gather
            cframe = CI.curve_shading_frame(scene.curves, c_hit.prim, p_hit)
            ng = torch.where(is_curve[:, None], cframe.normal, ng)
            ns = torch.where(is_curve[:, None], cframe.normal, ns)
            mid = torch.where(is_curve, cframe.material_id, mid)
        mrow = gather_rows(scene.mat_row, mid)           # ONE material row gather
        albedo = mcol(mrow, "albedo")
        albedo2 = mcol(mrow, "albedo2") if has_layered else None
        if cfg.has_noise:
            # the procedural noise tint at the world hit position, into the
            # lobe whose diffuse the MDL graph tinted (noise_target: the
            # shipped materials tint the base of a layer, lobe 2); the bump
            # moves the shading normal by the field's tangential gradient
            nz_mode = mcol(mrow, "noise_mode").to(torch.int64)
            nz_tgt = mcol(mrow, "noise_target").to(torch.int64)
            thr = mcol(mrow, "noise_thr")
            nz_scale = mcol(mrow, "noise_scale")
            field = (cfg.noise_levels_static, mcol(mrow, "noise_absolute").to(torch.int64), thr[:, 0], thr[:, 1],
                     mcol(mrow, "noise_marble").to(torch.int64))
            # with the bump, the field at the hit is the first of its four
            if cfg.has_noise_bump:
                values = NZ.bump_fields(nz_mode, p_hit, nz_scale, *field)
                value = values[0]
            else:
                value = NZ.noise_scalar(nz_mode, p_hit * nz_scale, *field)
            nz_tint = NZ.noise_tint(mcol(mrow, "noise_color1"), mcol(mrow, "noise_color2"), value)
            albedo = torch.where(((nz_mode > 0) & (nz_tgt == 0))[:, None], nz_tint, albedo)
            if has_layered:
                albedo2 = torch.where(((nz_mode > 0) & (nz_tgt == 1))[:, None], nz_tint, albedo2)
            if cfg.has_noise_bump:
                bump_factor = torch.where(nz_mode > 0, mcol(mrow, "noise_bump_factor"), 0.0)
                ns = NZ.noise_bump_normal(ns, nz_scale, bump_factor, values)
        # ---- textures and stochastic cutout (hit.cu:1400-1423) ----------
        passthrough = None
        if has_tex or has_cutout:
            # the texcoord from the triangle row, the material's uv transform
            uv_hit = apply_uv_transform(bary_uv(tsr[:, 18:24], hit.u, hit.v), mcol(mrow, "uv_xf"))
        if has_tex:
            tex_rgb = sample_bilinear(scene.atlas, tex_id(mrow, "albedo_tex"), uv_hit)[:, :3]
            if has_curves:  # a curve hit takes no texture
                tex_rgb = torch.where(is_curve[:, None], 1.0, tex_rgb)
            albedo = albedo * tex_rgb
        if has_cutout:
            rgba_cut = sample_bilinear(scene.atlas, tex_id(mrow, "cutout_tex"), uv_hit)
            opacity = mcol(mrow, "cutout_opacity") * rgba_cut[:, :3].mean(dim=-1)
            seed, u_cut = R.rng(seed)
            passthrough = hit_valid & (u_cut >= opacity)
            if has_curves:  # nor a cutout
                passthrough = passthrough & ~is_curve
            hit_valid = hit_valid & ~passthrough
        params = B.MaterialParams(
            archetype=mcol(mrow, "archetype").to(torch.int64),
            albedo=albedo,
            roughness=mcol(mrow, "roughness"),
            ior=mcol(mrow, "ior"),
            thin_walled=mcol(mrow, "thin_walled"),
        )
        if has_layered:
            # the second lobe and the blend / modifier descriptor, the lobe
            # weights and modifier at this view angle computed once
            params2 = params._replace(archetype=mcol(mrow, "archetype2").to(torch.int64), albedo=albedo2,
                                      roughness=mcol(mrow, "roughness2"))
            bp = LY.BlendParams(
                blend_mode=mcol(mrow, "blend_mode").to(torch.int64),
                w1=mcol(mrow, "blend_w1"),
                w2=mcol(mrow, "blend_w2"),
                blend_ior=mcol(mrow, "blend_ior"),
                curve=mcol(mrow, "curve").reshape(n, scene.mat_curve_k, 3),
                mod_mode=mcol(mrow, "mod_mode").to(torch.int64),
                mod_a=mcol(mrow, "mod_a"),
                mod_b=mcol(mrow, "mod_b"),
                mod_exp=mcol(mrow, "mod_exp"),
            )
            view = LY.view_weights(bp, wo, ns)
        # the reference's one optixTrace sums t across ignored any-hits, so
        # the area spread's distance includes the cutouts passed (hit.cu:536, 569)
        t_eff = hit.t + s.pass_dist if has_cutout else hit.t
        front = dot(wo, ng) >= 0.0
        ns_q = torch.where((~front)[:, None], -ns, ns)  # query normal (hit.cu:600)
        prev_non_dirac = (s.event & B.BSDF_EVENT_NON_DIRAC) != 0

        # ---- volume interactions (hit.cu:688-697, miss.cu:62-79) ---------
        pos_next, wi_next, hit_before = s.pos, s.wi, s.hit_before
        scatter_miss = None
        walk = s.walk
        if has_volumes:
            # a segment inside a medium: the transmittance over the
            # probability P(d > t) = sum_c p_c exp(-sigma_tc t) of flying
            # that far where the flight was drawn (the reference multiplies
            # by the bare transmittance, hit.cu:692, which attenuates a
            # scattering medium twice; both agree where nothing scatters)
            in_medium = (s.stack_idx > 0) & (hit_valid if passthrough is None else hit_valid | passthrough)
            trans_hit = torch.exp(-sigma_t * hit.t[:, None])
            p_surv = (pdf_volume * trans_hit).sum(dim=-1)
            w_hit = torch.where(can_step[:, None], trans_hit / torch.clamp(p_surv, min=1e-20)[:, None], trans_hit)
            throughput = torch.where(in_medium[:, None], s.throughput * w_hit, s.throughput)
            walk = walk + in_medium.to(torch.int64)
            # the flight ended inside the medium: advance, reweight, and a
            # Henyey-Greenstein direction about the current one
            # (raygeneration.cu:74-104)
            scatter_miss = can_step & ~(any_valid if has_curves else hit.valid)
            pos_next = torch.where(scatter_miss[:, None], s.pos + s.wi * dist_sample[:, None], s.pos)
            trans_m = torch.exp(-sigma_t * dist_sample[:, None])
            pdf_m = (pdf_volume * sigma_t * trans_m).sum(dim=-1)
            tp_m = top_ss * trans_m / torch.clamp(pdf_m, min=1e-20)[:, None]
            throughput = torch.where(scatter_miss[:, None], throughput * tp_m, throughput)
            walk = walk + scatter_miss.to(torch.int64)
            seed, xi_hg = R.rng2(seed)
            g = pick1(s.bias_stack, s.stack_idx)
            iso = torch.abs(g) < 1e-3
            sq = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * xi_hg[:, 0], min=1e-12)
            cos_hg = torch.where(iso, 1.0 - 2.0 * xi_hg[:, 0],
                                 (1.0 + g * g - sq * sq) / (2.0 * torch.where(iso, 1.0, g)))
            sin_hg = torch.sqrt(torch.clamp(1.0 - cos_hg * cos_hg, min=0.0))
            phi_hg = 2.0 * math.pi * xi_hg[:, 1]
            local = torch.stack([torch.cos(phi_hg) * sin_hg, torch.sin(phi_hg) * sin_hg, cos_hg], dim=-1)
            tb, bb = build_onb(s.wi)
            wi_next = torch.where(scatter_miss[:, None], to_world(tb, bb, s.wi, local), s.wi)
            # a volume step is no surface hit: the next segment starts at
            # the scatter point with tmin 0
            hit_before = s.hit_before & ~scatter_miss
            s = s._replace(throughput=throughput)

        # ---- miss: environment ------------------------------------------
        surface = any_valid if has_curves else hit.valid  # a triangle or a curve hit
        miss = active & ~surface if scatter_miss is None else active & ~surface & ~scatter_miss
        radiance = s.radiance
        env_em, env_pdf, has_env = env_radiance(lights, s.wi)
        if has_env:
            w_mis = torch.where(
                direct_lighting & prev_non_dirac, balance_heuristic(s.pdf, env_pdf), 1.0
            )
            contrib = s.throughput * env_em * w_mis[:, None]
            add_pixel = miss & ~s.suffix if train else miss
            radiance = radiance + torch.where(add_pixel[:, None], contrib, 0.0)
            s = add_to_last_record(s, contrib, miss)
        # a miss terminates: render query unused (miss.cu:97-104), a training
        # suffix ends unbiased (mask stays 0)
        lrt = torch.where(
            (miss & ~s.render_done)[:, None], 0.0, s.last_render_throughput
        )
        alive = s.alive & ~miss

        # ---- emission of the hit surface (mesh lights, hit.cu:738-821) --
        em_rad = mcol(mrow, "emission_radiance")
        if has_tex:
            em_rad = em_rad * sample_bilinear(scene.atlas, tex_id(mrow, "emission_tex"), uv_hit)[:, :3]
        cos_e = dot(ns, wo)
        emissive = hit_valid & front & (em_rad.amax(dim=-1) > 0.0) & (cos_e > 0.0)
        if num_lights:
            area = lights.area[torch.clamp(tri_light_id, min=0)]
            pdf_hit = safe_div(hit.t * hit.t, area * cos_e)
            w_mis_e = torch.where(
                direct_lighting & prev_non_dirac,
                balance_heuristic(s.pdf, pdf_hit),
                1.0,
            )
            emission = s.throughput * em_rad * w_mis_e[:, None]
            add_pixel = emissive & ~s.suffix if train else emissive
            radiance = radiance + torch.where(add_pixel[:, None], emission, 0.0)
            s = add_to_last_record(s, emission, emissive)

        # ---- area-spread termination decision (hit.cu:527-585) ----------
        abs_cos = torch.abs(dot(wo, ns))
        if first:
            threshold = sqrt_c * safe_div(
                t_eff, torch.sqrt(4.0 * math.pi * torch.clamp(abs_cos, min=1e-12))
            )
            area_threshold = torch.where(hit_valid, threshold, s.area_threshold)
            area_spread = s.area_spread
            terminate = false
        else:
            area_threshold = s.area_threshold
            if has_cutout:
                # the first real hit came after a cutout passthrough: the
                # camera's threshold (depth 0's formula) is set now
                thr0 = sqrt_c * safe_div(t_eff, torch.sqrt(4.0 * math.pi * torch.clamp(abs_cos, min=1e-12)))
                area_threshold = torch.where(hit_valid & torch.isinf(area_threshold), thr0, area_threshold)
            prev_specular = (s.event & B.BSDF_EVENT_SPECULAR) != 0
            pdf_prev = torch.where(s.pdf == 0.0, math.inf, s.pdf)
            delta = safe_div(
                t_eff, torch.sqrt(pdf_prev * torch.clamp(abs_cos, min=1e-12))
            )
            accum = hit_valid & ~prev_specular
            if train:  # the unbiased suffix never ends on the cache
                accum = accum & ~(s.unbiased & s.suffix)
            area_spread = s.area_spread + torch.where(accum, delta, 0.0)
            terminate = accum & (area_spread > area_threshold)
        if not truncate:
            terminate = false

        # ---- BSDF sample: the IORs from the medium stack (hit.cu:488-524) --
        seed, xi = R.rng4(seed)
        if transmissive:
            thin = params.thin_walled != 0
            top = pick1(s.ior_stack, s.stack_idx)
            below = pick1(s.ior_stack, torch.clamp(s.stack_idx - 1, min=0))
            outside = front | thin
            eta_i = torch.where(outside, top, params.ior)
            eta_t = torch.where(outside, params.ior, below)
        else:  # nothing transmits: no lobe reads the IORs
            eta_i = eta_t = params.ior
        if has_layered:
            seed, xi_lobe = R.rng(seed)
            sample = LY.layered_sample(params, params2, bp, view, wo, ns, ng,
                                       torch.cat([xi, xi_lobe[:, None]], dim=-1), eta_i, eta_t,
                                       families=cfg.archetype_set)
        else:
            sample = B.bsdf_sample(params, wo, ns, ng, xi, eta_i, eta_t, families=cfg.archetype_set)
        if has_measured:
            # the measured lobe on MEASURED lanes, about the normal turned to wo
            is_measured = params.archetype == int(Archetype.MEASURED)
            nf_m = torch.where((dot(wo, ns) >= 0.0)[:, None], ns, -ns)
            mb_idx = torch.clamp(mcol(mrow, "mbsdf_index").to(torch.int64), min=0)
            mb_mult = mcol(mrow, "mbsdf_multiplier")
            m_frame = MB.measured_frame(scene.mbsdf, mb_idx, wo, nf_m)
            wi_m, w_m, pdf_m, trans_m, ok_m = MB.measured_sample(scene.mbsdf, mb_idx, mb_mult, m_frame, nf_m,
                                                                 xi[:, :3])
            ev_m = torch.where(ok_m, torch.where(trans_m, B.BSDF_EVENT_GLOSSY_TRANSMISSION,
                                                 B.BSDF_EVENT_GLOSSY_REFLECTION), B.BSDF_EVENT_ABSORB)
            sample = B.BSDFSample(
                wi=torch.where(is_measured[:, None], wi_m, sample.wi),
                bsdf_over_pdf=torch.where(is_measured[:, None], w_m, sample.bsdf_over_pdf),
                pdf=torch.where(is_measured, pdf_m, sample.pdf),
                event=torch.where(is_measured, ev_m, sample.event),
            )
        if has_curves:
            # the Chiang hair BSDF on hair materials' curve hits, in the fibre
            # frame (bsdf_hair.mdl; tangent + the strand's azimuthal basis)
            hair_r = mcol(mrow, "hair_roughness").reshape(n, 3, 2)
            hpar = H.HairParams(
                sigma_a=mcol(mrow, "hair_absorption"),
                ior=params.ior,
                beta_m=hair_r[..., 0],
                beta_n=hair_r[..., 1],
                cuticle_angle=mcol(mrow, "hair_cuticle"),
                diffuse_weight=mcol(mrow, "hair_diffuse_weight"),
                diffuse_tint=mcol(mrow, "albedo") * cframe.color,
            )
            ct, cb1, cb2 = cframe.tangent, cframe.b1, cframe.b2

            def to_fiber(v):
                return torch.stack([dot(v, ct), dot(v, cb1), dot(v, cb2)], dim=-1)

            # h: the ray's azimuthal offset across the fibre
            b_view = cross(s.wi, ct)
            b_view = b_view / torch.clamp(torch.linalg.vector_norm(b_view, dim=-1, keepdim=True), min=1e-9)
            h_fib = torch.clamp(dot(cframe.normal, b_view), -1.0, 1.0)
            wo_l = to_fiber(wo)
            wi_l, w_over_h, pdf_h = H.hair_sample(hpar, wo_l, h_fib, xi)
            is_hair = is_curve & (params.archetype == int(Archetype.HAIR))
            wi_h = wi_l[:, 0:1] * ct + wi_l[:, 1:2] * cb1 + wi_l[:, 2:3] * cb2
            sample = B.BSDFSample(
                wi=torch.where(is_hair[:, None], wi_h, sample.wi),
                bsdf_over_pdf=torch.where(is_hair[:, None], w_over_h, sample.bsdf_over_pdf),
                pdf=torch.where(is_hair, pdf_h, sample.pdf),
                event=torch.where(is_hair & (pdf_h > 0.0), B.BSDF_EVENT_GLOSSY_REFLECTION,
                                  torch.where(is_hair, B.BSDF_EVENT_ABSORB, sample.event)),
            )
        # a cutout passthrough and a volume scatter step keep the previous
        # event for MIS (the ignored any-hit; stepVolume, miss.cu:62-79)
        keep_event = passthrough
        if scatter_miss is not None:
            keep_event = scatter_miss if keep_event is None else keep_event | scatter_miss
        if keep_event is not None:
            event = torch.where(hit_valid, sample.event,
                                torch.where(keep_event, s.event, B.BSDF_EVENT_ABSORB))
        else:
            event = torch.where(hit_valid, sample.event, B.BSDF_EVENT_ABSORB)
        event_non_dirac = (event & B.BSDF_EVENT_NON_DIRAC) != 0
        event_specular = (event & B.BSDF_EVENT_SPECULAR) != 0

        # ---- aux + cache-vis query (hit.cu:888-898) -----------------------
        if has_layered:
            aux = LY.layered_aux(params, params2, bp, view, families=cfg.archetype_set)
        else:
            aux = B.bsdf_aux(params, families=cfg.archetype_set)
        if has_measured:
            alb_m = MB.measured_aux(mb_mult, m_frame)
            aux = B.BSDFAux(
                albedo_diffuse=torch.where(is_measured[:, None], 0.0, aux.albedo_diffuse),
                albedo_glossy=torch.where(is_measured[:, None], alb_m, aux.albedo_glossy),
                roughness=torch.where(is_measured[:, None], 1.0, aux.roughness),
            )
        if has_curves:
            aux = B.BSDFAux(
                albedo_diffuse=torch.where(is_hair[:, None], hpar.diffuse_tint, aux.albedo_diffuse),
                albedo_glossy=torch.where(is_hair[:, None], torch.exp(-hpar.sigma_a) * cframe.color,
                                          aux.albedo_glossy),
                roughness=torch.where(is_hair[:, None], mcol(mrow, "hair_roughness")[:, 0:2], aux.roughness),
            )
        query_here = make_query(p_hit, wo, ns_q, aux, cfg.position_scale)
        first_ns = hit_valid & ~s.recorded_first & ~event_specular
        cache_vis_query = torch.where(first_ns[:, None], query_here, s.cache_vis_query)
        recorded_first = s.recorded_first | first_ns

        # ---- early absorb (hit.cu:900-920) --------------------------------
        absorbed = hit_valid & (event == B.BSDF_EVENT_ABSORB)
        zero_lrt = absorbed & ~s.suffix & ~s.render_done if train else absorbed & ~s.render_done
        lrt = torch.where(zero_lrt[:, None], 0.0, lrt)
        alive = alive & ~absorbed

        # ---- area-spread termination (hit.cu:924-971) ----------------------
        term = hit_valid & terminate & ~absorbed & alive
        render_query = s.render_query
        area_spread_next = area_spread
        rec = {}  # the training wavefront's new record state
        if not train:
            # render ray: query + lastRenderThroughput, then stop
            render_query = torch.where(term[:, None], query_here, render_query)
            lrt = torch.where(term[:, None], s.throughput, lrt)
            alive = alive & ~term
            render_done = s.render_done | term
        else:
            # a suffix end is the self-training end vertex (hit.cu:933-940)
            end_self = term & s.suffix
            end_query = torch.where(end_self[:, None], query_here, s.end_query)
            end_mask = torch.where(end_self, 1.0, s.end_mask)
            alive = alive & ~end_self
            # a render-path end switches into the suffix (hit.cu:941-959);
            # with the record slots already exhausted the ray stops
            # (hit.cu:950-953)
            to_suffix = term & ~s.suffix
            alive = alive & ~(to_suffix & s.full)
            suffix = s.suffix | to_suffix
            area_spread_next = torch.where(to_suffix, 0.0, area_spread)
            render_done = s.render_done | to_suffix

            # ---- allocate a training record (hit.cu:975-1028) --------------
            want = alive & hit_valid & event_non_dirac & ~s.full
            overflow = want & (s.rec_count >= d_rec)
            allocated = want & (s.rec_count < d_rec)
            slot = torch.clamp(s.rec_count, max=d_rec - 1)
            rec_count = s.rec_count + allocated.to(torch.int64)
            # overflow: a forced self-training end here (hit.cu:1009-1027)
            alive = alive & ~overflow
            rec = dict(
                suffix=suffix,
                full=s.full | overflow,
                rec_count=rec_count,
                rec_query=put1(s.rec_query, slot, query_here, allocated),
                rec_ltp=put1(s.rec_ltp, slot, sample.bsdf_over_pdf, allocated),
                rec_target=s.rec_target,
                end_query=torch.where(overflow[:, None], query_here, end_query),
                end_mask=torch.where(overflow, 1.0, end_mask),
            )

        # ---- NEE / direct lighting (hit.cu:343-443, 1030-1056) ------------
        shadow_traced = torch.zeros_like(s.traced)
        if direct_lighting:
            seed, xi_l = R.rng4(seed)
            ls = sample_lights(lights, p_hit, xi_l, tex_ctx=nee_tex_ctx)
            if has_layered:
                ev = LY.layered_eval(params, params2, bp, view, wo, ls.direction, ns, eta_i, eta_t,
                                     families=cfg.archetype_set)
            else:
                ev = B.bsdf_eval(params, wo, ls.direction, ns, eta_i, eta_t, families=cfg.archetype_set)
            if has_measured:
                fcos_m, pdf_em = MB.measured_eval(scene.mbsdf, mb_idx, mb_mult, m_frame, ls.direction, nf_m)
                ev = B.BSDFEval(bsdf=torch.where(is_measured[:, None], fcos_m, ev.bsdf),
                                pdf=torch.where(is_measured, pdf_em, ev.pdf))
            if has_curves:
                f_h, pdf_eh = H.hair_eval(hpar, wo_l, to_fiber(ls.direction), h_fib)
                ev = B.BSDFEval(bsdf=torch.where(is_hair[:, None], f_h, ev.bsdf),
                                pdf=torch.where(is_hair, pdf_eh, ev.pdf))
            do_nee = alive & hit_valid & event_non_dirac
            valid_ls = (ls.pdf > 0.0) & (ev.bsdf.amax(dim=-1) > 0.0) & (ev.pdf > 0.0)
            w_mis_l = torch.where(ls.is_singular, 1.0, balance_heuristic(ls.pdf, ev.pdf))
            direct = ev.bsdf * ls.radiance_over_pdf * (float(num_lights) * w_mis_l)[:, None]
            if cfg.nee_rr_tau > 0.0:
                # shadow-ray Russian roulette (nrc_tpu/render/integrator.py:
                # 907-922): survive with p = lum(unoccluded contribution) /
                # tau, floored at 0.05, scaled by 1 / p. Pixel rays weigh by
                # the path throughput, training rays take the record's raw
                # target. The uniform is one LCG step of the seed xor
                # 0x9E3779B9, a side stream: the main stream is the same
                # with the feature on or off.
                ref_rgb = direct if train else s.throughput * direct
                lum_sh = 0.3 * ref_rgb[:, 0] + 0.59 * ref_rgb[:, 1] + 0.11 * ref_rgb[:, 2]
                p_sh = torch.clamp(lum_sh * (1.0 / cfg.nee_rr_tau), 0.05, 1.0)
                _, u_sh_rr = R.rng(seed ^ 0x9E3779B9)
                valid_ls = valid_ls & (u_sh_rr < p_sh)
                direct = direct * (1.0 / p_sh)[:, None]
            shadow_tmax = torch.where(do_nee & valid_ls, ls.distance - eps, 0.0)
            if has_cutout:
                # three closest-hit hops through cutouts, each blocked with
                # probability = opacity; the tail counts as visible
                # (nrc_tpu/render/integrator.py:925-990, without the
                # NRC_CUTOUT_FAST pre-pass). The uniforms are drawn first,
                # so the stream does not depend on where the hops end.
                u_hops = []
                for _ in range(3):
                    seed, u_h = R.rng(seed)
                    u_hops.append(u_h)
                occluded = false
                sh_tmin = torch.full_like(shadow_tmax, eps)
                sh_done = shadow_tmax <= 0.0
                for u_h in u_hops:
                    if _all_done(~sh_done):
                        break
                    shadow_traced = shadow_traced + (~sh_done).to(torch.int64)
                    sh = closest_hit(p_hit, ls.direction, sh_tmin, torch.where(sh_done, 0.0, shadow_tmax))
                    op = cutout_opacity_at(torch.clamp(sh.prim, min=0), sh.u, sh.v)
                    blocked = sh.valid & (u_h < op) & ~sh_done
                    occluded = occluded | blocked
                    cont = sh.valid & ~blocked & ~sh_done
                    sh_tmin = torch.where(cont, sh.t + eps, sh_tmin)
                    sh_done = sh_done | ~cont
            else:
                occluded = any_hit(p_hit, ls.direction, torch.full_like(shadow_tmax, eps), shadow_tmax)
                shadow_traced = (shadow_tmax > 0.0).to(torch.int64)
            if has_curves:  # the curves occlude too (JAX :1012-1016)
                occluded = occluded | CI.occluded_curves_bvh(
                    p_hit, ls.direction, scene.curve_bvh, torch.full_like(shadow_tmax, eps), shadow_tmax)
            ok = do_nee & valid_ls & ~occluded
            if train:
                # NEE into the record just written (hit.cu:1030-1056)
                direct = torch.where(ok[:, None], direct, 0.0)
                slot = torch.clamp(torch.clamp(rec["rec_count"] - 1, min=0), max=d_rec - 1)
                rec["rec_target"] = add1(rec["rec_target"], slot, direct, allocated)
                ok = ok & ~rec["suffix"]
            radiance = radiance + torch.where(ok[:, None], s.throughput * direct, 0.0)

        # ---- advance the path ---------------------------------------------
        throughput = torch.where(
            hit_valid[:, None], s.throughput * sample.bsdf_over_pdf, s.throughput
        )
        # the nested-medium stack on transmission through a boundary
        # (hit.cu:488-524): entering pushes the material's IOR (and its
        # medium), leaving pops; a thin-walled surface leaves the stack alone
        stack_idx, ior_stack = s.stack_idx, s.ior_stack
        media = {}
        if transmissive:
            transmit = hit_valid & ((event & B.BSDF_EVENT_TRANSMISSION) != 0) & ~thin
            push = transmit & front
            pop = transmit & ~front
            stack_idx = torch.clamp(
                stack_idx + push.to(torch.int64) - pop.to(torch.int64), 0, IOR_STACK_DEPTH - 1
            )
            ior_stack = put1(ior_stack, stack_idx, params.ior, push)
            if has_volumes:
                media = dict(
                    sigma_a_stack=put1(s.sigma_a_stack, stack_idx, mcol(mrow, "sigma_a"), push),
                    sigma_s_stack=put1(s.sigma_s_stack, stack_idx, mcol(mrow, "sigma_s"), push),
                    bias_stack=put1(s.bias_stack, stack_idx, mcol(mrow, "volume_bias"), push),
                )
                # crossing any boundary resets the walk (hit.cu:523)
                walk = torch.where(transmit, 0, walk)
        if train:
            # unbiased-suffix Russian roulette (raygeneration.cu:245-262); it
            # draws one number per bounce on every training ray
            seed, u_rr = R.rng(seed)
            do_rr = alive & s.unbiased & rec["suffix"] & (depth >= cfg.min_depth_rr)
            prob = torch.clamp(throughput.amax(dim=-1), min=0.005)
            kill = do_rr & (prob < u_rr)
            throughput = torch.where((do_rr & ~kill)[:, None], throughput / prob[:, None], throughput)
            alive = alive & ~kill  # an unbiased end: the mask stays 0
        moved = hit_valid
        if has_cutout:
            moved = hit_valid | passthrough
            s = s._replace(pass_dist=torch.where(passthrough, s.pass_dist + hit.t,
                                                 torch.where(hit_valid, 0.0, s.pass_dist)))
        # work events: surface hits, cutout passthroughs, volume scatter steps
        events = moved if scatter_miss is None else moved | scatter_miss
        return s._replace(
            **rec,
            **media,
            walk=walk,
            pos=torch.where(moved[:, None], p_hit, pos_next),
            wi=torch.where(hit_valid[:, None], sample.wi, wi_next),
            seed=seed,
            throughput=throughput,
            radiance=radiance,
            pdf=torch.where(hit_valid, sample.pdf, s.pdf),
            event=event,
            alive=alive,
            hit_before=hit_before | moved,
            area_spread=area_spread_next,
            area_threshold=area_threshold,
            recorded_first=recorded_first,
            render_done=render_done,
            ior_stack=ior_stack,
            stack_idx=stack_idx,
            bounces=s.bounces + events.to(torch.int64),
            traced=s.traced + active.to(torch.int64) + shadow_traced,
            last_render_throughput=lrt,
            render_query=render_query,
            cache_vis_query=cache_vis_query,
        )

    # depth 0 sets the camera's area threshold; depths 1..max_depth
    # accumulate the spread (off the card they stop once every lane has
    # terminated)
    wavefront = "train" if train else "render"
    if spans is not None:
        spans.bounce(wavefront, 0, state.alive)
    state = bounce(state, True, 0)
    for depth in range(1, cfg.max_depth + 1):
        if _all_done(state.alive):
            break
        if spans is not None:
            spans.bounce(wavefront, depth, state.alive)
        state = bounce(state, False, depth)

    # max-depth cleanup (raygeneration.cu:274-284): surviving render rays
    # contribute no cache radiance; surviving training rays end unbiased
    still = state.alive & ~state.render_done
    lrt = torch.where(still[:, None], 0.0, state.last_render_throughput)
    return WavefrontOut(
        radiance=state.radiance,
        bounce_count=state.bounces,
        traced_count=state.traced,
        render_query=state.render_query,
        last_render_throughput=lrt,
        cache_vis_query=state.cache_vis_query,
        rec_query=state.rec_query,
        rec_ltp=state.rec_ltp,
        rec_target=state.rec_target,
        rec_count=state.rec_count,
        end_query=state.end_query,
        end_mask=state.end_mask,
    )
