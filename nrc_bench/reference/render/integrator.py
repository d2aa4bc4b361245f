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

The reference covers the benchmark's scenes: triangles under mesh lights,
with the archetypes of ``ops/bsdf.py``, a medium stack of IORs and no
environment. The port's textures, cutouts, layered, measured and noise
materials, media, declared lights and curves are not copied; a scene that
has them is refused (``render/scene_device.py::check_supported``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import FrameConfig, RenderMode
from ..ops import bsdf as B
from ..ops.gather import gather_rows
from ..ops.intersect import RT_MAX, Hit, make_intersectors
from ..ops.light_sampling import sample_lights
from ..scene.materials import Archetype
from ..utils import rng as R
from ..utils.math import (
    add1,
    balance_heuristic,
    cartesian_to_spherical_unit,
    cross,
    dot,
    normalize,
    pick1,
    put1,
    safe_div,
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
    return not bool(alive.any())


def trace_wavefront(
    scene: DeviceScene,
    org: torch.Tensor,        # [N, 3] primary ray origins
    direction: torch.Tensor,  # [N, 3]
    seeds: torch.Tensor,      # [N] i64 (after lens-jitter consumption)
    cfg: FrameConfig,
    train: bool = False,
    unbiased: Optional[torch.Tensor] = None,  # [N] bool, training wavefront
    primary_hit: Optional[Hit] = None,  # depth 0's hit, resolved before (the primary raster)
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
    # JAX program computes it always and XLA drops what nothing reads)
    transmissive = B.transmits(
        cfg.archetype_set, Archetype.GGX_TRANSMIT, Archetype.GGX_REFLECT_TRANSMIT,
        Archetype.SPECULAR_TRANSMIT, Archetype.SPECULAR_REFLECT_TRANSMIT, Archetype.DIFFUSE_TRANSMISSION,
    )
    offs, _ = mat_row_layout()

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
        ior_stack=torch.ones((n, IOR_STACK_DEPTH), dtype=torch.float32, device=dev),
        stack_idx=zeros(dtype=torch.int64),
        bounces=zeros(dtype=torch.int64),
        traced=zeros(dtype=torch.int64),
        last_render_throughput=zeros(3),
        render_query=zeros(QUERY_DIMS),
        cache_vis_query=zeros(QUERY_DIMS),
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

        # depth 0 of the render wavefront may come resolved by the primary
        # raster (ops/raster_primary.py; tmin 0 and tmax RT_MAX there)
        hit = primary_hit if first and primary_hit is not None else closest_hit(s.pos, s.wi, tmin, tmax)
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
        mrow = gather_rows(scene.mat_row, mid)           # ONE material row gather
        params = B.MaterialParams(
            archetype=mcol(mrow, "archetype").to(torch.int64),
            albedo=mcol(mrow, "albedo"),
            roughness=mcol(mrow, "roughness"),
            ior=mcol(mrow, "ior"),
            thin_walled=mcol(mrow, "thin_walled"),
        )
        front = dot(wo, ng) >= 0.0
        ns_q = torch.where((~front)[:, None], -ns, ns)  # query normal (hit.cu:600)
        prev_non_dirac = (s.event & B.BSDF_EVENT_NON_DIRAC) != 0

        # ---- miss: no environment, so nothing to add ----------------------
        miss = active & ~hit.valid
        radiance = s.radiance
        # a miss terminates: render query unused (miss.cu:97-104), a training
        # suffix ends unbiased (mask stays 0)
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
            add_pixel = emissive & ~s.suffix if train else emissive
            radiance = radiance + torch.where(add_pixel[:, None], emission, 0.0)
            s = add_to_last_record(s, emission, emissive)

        # ---- area-spread termination decision (hit.cu:527-585) ----------
        abs_cos = torch.abs(dot(wo, ns))
        if first:
            threshold = sqrt_c * safe_div(
                hit.t, torch.sqrt(4.0 * math.pi * torch.clamp(abs_cos, min=1e-12))
            )
            area_threshold = torch.where(hit_valid, threshold, s.area_threshold)
            area_spread = s.area_spread
            terminate = false
        else:
            area_threshold = s.area_threshold
            prev_specular = (s.event & B.BSDF_EVENT_SPECULAR) != 0
            pdf_prev = torch.where(s.pdf == 0.0, math.inf, s.pdf)
            delta = safe_div(
                hit.t, torch.sqrt(pdf_prev * torch.clamp(abs_cos, min=1e-12))
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
        sample = B.bsdf_sample(params, wo, ns, ng, xi, eta_i, eta_t, families=cfg.archetype_set)
        event = torch.where(hit_valid, sample.event, B.BSDF_EVENT_ABSORB)
        event_non_dirac = (event & B.BSDF_EVENT_NON_DIRAC) != 0
        event_specular = (event & B.BSDF_EVENT_SPECULAR) != 0

        # ---- aux + cache-vis query (hit.cu:888-898) -----------------------
        aux = B.bsdf_aux(params, families=cfg.archetype_set)
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
            ls = sample_lights(lights, p_hit, xi_l)
            ev = B.bsdf_eval(params, wo, ls.direction, ns, eta_i, eta_t, families=cfg.archetype_set)
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
            occluded = any_hit(p_hit, ls.direction, torch.full_like(shadow_tmax, eps), shadow_tmax)
            shadow_traced = (shadow_tmax > 0.0).to(torch.int64)
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
        # (hit.cu:488-524): entering pushes the material's IOR, leaving
        # pops; a thin-walled surface leaves the stack alone
        stack_idx, ior_stack = s.stack_idx, s.ior_stack
        if transmissive:
            transmit = hit_valid & ((event & B.BSDF_EVENT_TRANSMISSION) != 0) & ~thin
            push = transmit & front
            pop = transmit & ~front
            stack_idx = torch.clamp(
                stack_idx + push.to(torch.int64) - pop.to(torch.int64), 0, IOR_STACK_DEPTH - 1
            )
            ior_stack = put1(ior_stack, stack_idx, params.ior, push)
        if train:
            # unbiased-suffix Russian roulette (raygeneration.cu:245-262); it
            # draws one number per bounce on every training ray
            seed, u_rr = R.rng(seed)
            do_rr = alive & s.unbiased & rec["suffix"] & (depth >= cfg.min_depth_rr)
            prob = torch.clamp(throughput.amax(dim=-1), min=0.005)
            kill = do_rr & (prob < u_rr)
            throughput = torch.where((do_rr & ~kill)[:, None], throughput / prob[:, None], throughput)
            alive = alive & ~kill  # an unbiased end: the mask stays 0
        return s._replace(
            **rec,
            pos=torch.where(hit_valid[:, None], p_hit, s.pos),
            wi=torch.where(hit_valid[:, None], sample.wi, s.wi),
            seed=seed,
            throughput=throughput,
            radiance=radiance,
            pdf=torch.where(hit_valid, sample.pdf, s.pdf),
            event=event,
            alive=alive,
            hit_before=s.hit_before | hit_valid,
            area_spread=area_spread_next,
            area_threshold=area_threshold,
            recorded_first=recorded_first,
            render_done=render_done,
            ior_stack=ior_stack,
            stack_idx=stack_idx,
            bounces=s.bounces + hit_valid.to(torch.int64),
            traced=s.traced + active.to(torch.int64) + shadow_traced,
            last_render_throughput=lrt,
            render_query=render_query,
            cache_vis_query=cache_vis_query,
        )

    # depth 0 sets the camera's area threshold; depths 1..max_depth
    # accumulate the spread (off the card they stop once every lane has
    # terminated)
    state = bounce(state, True, 0)
    for depth in range(1, cfg.max_depth + 1):
        if _all_done(state.alive):
            break
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
