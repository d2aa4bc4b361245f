"""Wavefront path tracer: the render wavefront of one frame.

Port of ``nrc_tpu/render/integrator.py:131-1190`` for the render wavefront
(``train=False``; reference ``__raygen__nrc_path_tracer`` +
``__closesthit__radiance``, ``raygeneration.cu:139-289``,
``hit.cu:672-1064``). All rays advance together one bounce at a time; every
branch is a masked select, as in the JAX package, so per-ray results agree
with it. Per bounce: closest hit, emission with MIS, area-spread truncation
into the cache (paper Eq. 2-4, ``hit.cu:527-585``), BSDF sampling, next-event
estimation with MIS and a shadow ray, and the ``traced_count`` accounting.
Path Russian roulette exists only on the training suffix in the reference,
so the render wavefront has none.

The JAX package splits large wavefronts into bands under ``lax.map``
(``trace_wavefront_chunked``); the outputs are per ray, so one pass over all
rays computes the same thing. The bounce loop stops when no ray is alive,
like the JAX ``while_loop`` (one device-to-host read of a flag per bounce).

Transport features that are not ported (training records, volumes,
textures, cutouts, layered/measured/noise materials, curves, shadow-ray
Russian roulette) raise when their ``FrameConfig`` switch is on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import FrameConfig, RenderMode
from ..ops import bsdf as B
from ..ops.intersect import RT_MAX, make_intersectors
from ..ops.light_sampling import env_radiance, sample_lights
from ..utils import rng as R
from ..utils.math import (
    balance_heuristic,
    cartesian_to_spherical_unit,
    cross,
    dot,
    normalize,
    safe_div,
)
from .scene_device import DeviceScene, mat_row_layout

QUERY_DIMS = 15  # pos3 + dir2 + normal2 + rough2 + diffuse3 + specular3

_UNPORTED_FLAGS = (
    "train", "has_volumes", "has_textures", "has_cutout", "has_layered",
    "has_measured", "has_noise", "has_noise_bump", "reflectance_factoring",
)


def check_frame_config(cfg: FrameConfig) -> None:
    for flag in _UNPORTED_FLAGS:
        if getattr(cfg, flag):
            if flag == "train":
                raise NotImplementedError("training lands with K4-K6")
            raise NotImplementedError(f"FrameConfig.{flag} is not ported yet")
    if cfg.nee_rr_tau > 0.0:
        raise NotImplementedError("shadow-ray Russian roulette (nee_rr_tau > 0) is not ported")


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
    """Per-ray outputs of the render wavefront (N = #rays)."""

    radiance: torch.Tensor                # [N, 3] path-traced radiance
    bounce_count: torch.Tensor            # [N] i64 surface hits
    traced_count: torch.Tensor            # [N] i64 rays actually cast: closest-hit
    #   segments of live lanes + shadow rays with a valid light sample
    render_query: torch.Tensor            # [N, 15] query at the truncation vertex
    last_render_throughput: torch.Tensor  # [N, 3] (0 -> query unused)
    cache_vis_query: torch.Tensor         # [N, 15] first non-specular vertex


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
    bounces: torch.Tensor
    traced: torch.Tensor
    last_render_throughput: torch.Tensor
    render_query: torch.Tensor
    cache_vis_query: torch.Tensor


def trace_wavefront(
    scene: DeviceScene,
    org: torch.Tensor,        # [N, 3] primary ray origins
    direction: torch.Tensor,  # [N, 3]
    seeds: torch.Tensor,      # [N] i64 (after lens-jitter consumption)
    cfg: FrameConfig,
) -> WavefrontOut:
    check_frame_config(cfg)
    n = org.shape[0]
    dev = org.device
    closest_hit, any_hit = make_intersectors(scene.tris, scene.planes)
    lights = scene.lights
    num_lights = lights.num
    truncate = cfg.render_mode != RenderMode.NO_CACHE
    direct_lighting = cfg.direct_lighting and num_lights > 0
    eps = cfg.scene_epsilon
    sqrt_c = cfg.area_spread_sqrt  # sqrt(c), paper Eq. 4; default c = 0.01
    offs, _ = mat_row_layout(scene.mat_curve_k)

    def mcol(row, name):
        a, b = offs[name]
        return row[:, a] if b == a + 1 else row[:, a:b]

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
        bounces=zeros(dtype=torch.int64),
        traced=zeros(dtype=torch.int64),
        last_render_throughput=zeros(3),
        render_query=zeros(QUERY_DIMS),
        cache_vis_query=zeros(QUERY_DIMS),
    )

    def bounce(s: _State, first: bool) -> _State:
        active = s.alive
        wo = -s.wi
        tmin = torch.where(s.hit_before, eps, 0.0)
        # inactive lanes trace a degenerate ray (empty t range)
        tmax = torch.where(active, RT_MAX, 0.0)
        seed = s.seed

        hit = closest_hit(s.pos, s.wi, tmin, tmax)
        hit_valid = hit.valid & active
        tri = torch.clamp(hit.prim, min=0)
        w_bary = 1.0 - hit.u - hit.v
        p_hit = s.pos + hit.t[:, None] * s.wi
        # ONE triangle row gather for all the hit's triangle-side inputs
        tsr = scene.tri_shade[tri]                       # [N, 24]
        ng = normalize(cross(tsr[:, 3:6], tsr[:, 6:9]))
        ns = normalize(
            w_bary[:, None] * tsr[:, 9:12]
            + hit.u[:, None] * tsr[:, 12:15]
            + hit.v[:, None] * tsr[:, 15:18]
        )
        meta = scene.tri_meta[tri]
        mid, tri_light_id = meta[:, 0], meta[:, 1]
        mrow = scene.mat_row[mid]                        # ONE material row gather
        params = B.MaterialParams(
            archetype=mcol(mrow, "archetype").to(torch.int64),
            albedo=mcol(mrow, "albedo"),
            roughness=mcol(mrow, "roughness"),
        )
        t_eff = hit.t
        front = dot(wo, ng) >= 0.0
        ns_q = torch.where((~front)[:, None], -ns, ns)  # query normal (hit.cu:600)
        prev_non_dirac = (s.event & B.BSDF_EVENT_NON_DIRAC) != 0

        # ---- miss: environment ------------------------------------------
        miss = active & ~hit.valid
        radiance = s.radiance
        env_em, env_pdf, has_env = env_radiance(lights, s.wi)
        if has_env:
            w_mis = torch.where(
                direct_lighting & prev_non_dirac, balance_heuristic(s.pdf, env_pdf), 1.0
            )
            contrib = s.throughput * env_em * w_mis[:, None]
            radiance = radiance + torch.where(miss[:, None], contrib, 0.0)
        # a miss terminates: render query unused (miss.cu:97-104)
        lrt = torch.where(
            (miss & ~s.render_done)[:, None], 0.0, s.last_render_throughput
        )
        alive = s.alive & ~miss

        # ---- emission of the hit surface (mesh lights, hit.cu:738-821) --
        em_rad = mcol(mrow, "emission_radiance")
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
            radiance = radiance + torch.where(emissive[:, None], emission, 0.0)

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
            prev_specular = (s.event & B.BSDF_EVENT_SPECULAR) != 0
            pdf_prev = torch.where(s.pdf == 0.0, math.inf, s.pdf)
            delta = safe_div(
                t_eff, torch.sqrt(pdf_prev * torch.clamp(abs_cos, min=1e-12))
            )
            accum = hit_valid & ~prev_specular
            area_spread = s.area_spread + torch.where(accum, delta, 0.0)
            terminate = accum & (area_spread > area_threshold)
        if not truncate:
            terminate = false

        # ---- BSDF sample --------------------------------------------------
        seed, xi = R.rng4(seed)
        sample = B.bsdf_sample(params, wo, ns, ng, xi)
        event = torch.where(hit_valid, sample.event, B.BSDF_EVENT_ABSORB)
        event_non_dirac = (event & B.BSDF_EVENT_NON_DIRAC) != 0
        event_specular = (event & B.BSDF_EVENT_SPECULAR) != 0

        # ---- aux + cache-vis query (hit.cu:888-898) -----------------------
        aux = B.bsdf_aux(params)
        query_here = make_query(p_hit, wo, ns_q, aux, cfg.position_scale)
        first_ns = hit_valid & ~s.recorded_first & ~event_specular
        cache_vis_query = torch.where(first_ns[:, None], query_here, s.cache_vis_query)
        recorded_first = s.recorded_first | first_ns

        # ---- early absorb (hit.cu:900-920) --------------------------------
        absorbed = hit_valid & (event == B.BSDF_EVENT_ABSORB)
        lrt = torch.where((absorbed & ~s.render_done)[:, None], 0.0, lrt)
        alive = alive & ~absorbed

        # ---- area-spread termination: query + lastRenderThroughput, stop --
        term = hit_valid & terminate & ~absorbed & alive
        render_query = torch.where(term[:, None], query_here, s.render_query)
        lrt = torch.where(term[:, None], s.throughput, lrt)
        alive = alive & ~term
        render_done = s.render_done | term

        # ---- NEE / direct lighting (hit.cu:343-443, 1030-1056) ------------
        shadow_traced = torch.zeros_like(s.traced)
        if direct_lighting:
            seed, xi_l = R.rng4(seed)
            ls = sample_lights(lights, p_hit, xi_l)
            ev = B.bsdf_eval(params, wo, ls.direction, ns)
            do_nee = alive & hit_valid & event_non_dirac
            valid_ls = (ls.pdf > 0.0) & (ev.bsdf.amax(dim=-1) > 0.0) & (ev.pdf > 0.0)
            w_mis_l = torch.where(ls.is_singular, 1.0, balance_heuristic(ls.pdf, ev.pdf))
            direct = ev.bsdf * ls.radiance_over_pdf * (float(num_lights) * w_mis_l)[:, None]
            shadow_tmax = torch.where(do_nee & valid_ls, ls.distance - eps, 0.0)
            occluded = any_hit(p_hit, ls.direction, torch.full_like(shadow_tmax, eps), shadow_tmax)
            shadow_traced = (shadow_tmax > 0.0).to(torch.int64)
            ok = do_nee & valid_ls & ~occluded
            radiance = radiance + torch.where(ok[:, None], s.throughput * direct, 0.0)

        # ---- advance the path ---------------------------------------------
        throughput = torch.where(
            hit_valid[:, None], s.throughput * sample.bsdf_over_pdf, s.throughput
        )
        return _State(
            pos=torch.where(hit_valid[:, None], p_hit, s.pos),
            wi=torch.where(hit_valid[:, None], sample.wi, s.wi),
            seed=seed,
            throughput=throughput,
            radiance=radiance,
            pdf=torch.where(hit_valid, sample.pdf, s.pdf),
            event=event,
            alive=alive,
            hit_before=s.hit_before | hit_valid,
            area_spread=area_spread,
            area_threshold=area_threshold,
            recorded_first=recorded_first,
            render_done=render_done,
            bounces=s.bounces + hit_valid.to(torch.int64),
            traced=s.traced + active.to(torch.int64) + shadow_traced,
            last_render_throughput=lrt,
            render_query=render_query,
            cache_vis_query=cache_vis_query,
        )

    # depth 0 sets the camera's area threshold; depths 1..max_depth
    # accumulate the spread and stop once every lane has terminated
    state = bounce(state, True)
    for _ in range(cfg.max_depth):
        if not bool(state.alive.any()):
            break
        state = bounce(state, False)

    # max-depth cleanup (raygeneration.cu:274-284): surviving render rays
    # contribute no cache radiance
    still = state.alive & ~state.render_done
    lrt = torch.where(still[:, None], 0.0, state.last_render_throughput)
    return WavefrontOut(
        radiance=state.radiance,
        bounce_count=state.bounces,
        traced_count=state.traced,
        render_query=state.render_query,
        last_render_throughput=lrt,
        cache_vis_query=state.cache_vis_query,
    )
