"""Port parity: homogeneous volumes, ray by ray through both packages'
``trace_wavefront``.

The sphere of ``tests/test_volumes.py:22-80``: a 48 x 24 sphere of radius
1 whose surface is an index-matched dielectric boundary
(``SPECULAR_REFLECT_TRANSMIT``, IOR 1) around a homogeneous medium, under
a constant white environment; 256 parallel rays through its middle, no
next-event estimation, NO_CACHE, up to 8 or 20 bounces. The media:
absorbing only (Beer-Lambert), isotropic scattering, forward scattering
(g = 0.9) with a long walk, and a coloured medium that scatters and
absorbs behind a refracting boundary (IOR 1.33). The host scene is the
JAX package's, handed to both uploads.

Both sides log every closest-hit ray (the JAX wavefront on the TPU plane
kernels under ``interpret=True``, the port on the plain K1), as the slice
tests do; a ray whose hit the two sides decided apart
(``test_torch_slice.ray_flips``) is left out. Every other ray must take
the same number of surface hits and scatter steps and trace the same rays,
and its radiance is held to the box frames' bound
(``test_torch_slice.LIMITS["radiance_rel"]``). The stream of uniforms is
the same on both sides; the distances and transmittances round ``log``
and ``exp`` a few ulp apart.

Each medium runs at two heights. The JAX test's rays lie in the plane
z = 0, which holds edges of the mesh: every hit there falls on an edge
that two triangles share, and the two intersectors decide that edge apart
(one takes one triangle, the other the other, or none); a direction
refracted there lies in the plane, its z a rounding residue whose sign the
scattering frame takes. There every ray whose path parts must first part
at one of these two decisions (``_edge_plane_decisions``). Lifted 0.0137
off that plane, no ray may flip beyond the box's share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nrc_tpu.render.integrator as jax_integrator
import nrc_tpu_torch.render.integrator as port_integrator
from nrc_tpu.config import FrameConfig as JFrameConfig
from nrc_tpu.config import RenderMode as JRenderMode
from nrc_tpu.ops import intersect_pallas as JP
from nrc_tpu.render.scene_device import upload_scene as jax_upload_scene
from nrc_tpu.scene import geometry as jgeo
from nrc_tpu.scene.camera import Camera as JCamera
from nrc_tpu.scene.lights import TYPE_LIGHT_ENV_CONST, empty_light_table
from nrc_tpu.scene.materials import Archetype as JArchetype
from nrc_tpu.scene.materials import Material as JMaterial
from nrc_tpu.scene.materials import MaterialTable as JMaterialTable
from nrc_tpu.scene.scene_builder import Scene as JScene
from nrc_tpu.utils import rng as JR
from nrc_tpu_torch.config import FrameConfig, RenderMode
from nrc_tpu_torch.render.scene_device import upload_scene
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_slice import LIMITS, _LOG, _jax_log
from test_torch_train_slice import _flipped

N_RAYS = 256
HEIGHTS = {"edge_plane": 0.0, "lifted": 0.0137}
# the nearer hit of a ray's first flipped call, min(u, v, 1 - u - v), and a
# direction's z on the plane z = 0: read 0 to float32 rounding (at most
# 2.4e-7 and 2e-9)
EDGE_BARY = 1e-6
# directions that agree read a few ulp apart; parted ones 0.1 and more
DIR_APART = 1e-4


def sphere_scene(sigma_a=(0, 0, 0), sigma_s=(0, 0, 0), bias=0.0, ior=1.0) -> JScene:
    """``tests/test_volumes.py::make_sphere_scene``'s host scene (before its
    upload), with the boundary's IOR as a parameter."""
    mesh = jgeo.create_sphere(48, 24)
    idx = mesh.indices.astype(int)
    mats = [JMaterial(name="glass", archetype=JArchetype.SPECULAR_REFLECT_TRANSMIT, albedo=(1.0, 1.0, 1.0),
                      ior=ior, sigma_a=sigma_a, sigma_s=sigma_s, volume_bias=bias)]
    lt = dataclasses.replace(
        empty_light_table(),
        type=np.asarray([TYPE_LIGHT_ENV_CONST], np.int32),
        matrix=np.eye(4, dtype=np.float32)[None],
        matrix_inv=np.eye(4, dtype=np.float32)[None],
        emission=np.asarray([[1.0, 1.0, 1.0]], np.float32),
        area=np.zeros(1, np.float32),
        inv_integral=np.zeros(1, np.float32),
        spot_angle_half=np.zeros(1, np.float32),
        spot_exponent=np.zeros(1, np.float32),
        material_id=np.full(1, -1, np.int32),
        tri_start=np.zeros(1, np.int32),
        tri_count=np.zeros(1, np.int32),
    )
    return JScene(
        p0=mesh.vertices[idx[:, 0]], p1=mesh.vertices[idx[:, 1]], p2=mesh.vertices[idx[:, 2]],
        n0=mesh.normals[idx[:, 0]], n1=mesh.normals[idx[:, 1]], n2=mesh.normals[idx[:, 2]],
        uv0=mesh.texcoords[idx[:, 0]], uv1=mesh.texcoords[idx[:, 1]], uv2=mesh.texcoords[idx[:, 2]],
        material_id=np.zeros(mesh.num_triangles, np.int32),
        light_id=np.full(mesh.num_triangles, -1, np.int32),
        materials=JMaterialTable.build(mats),
        material_rows=mats,
        lights=lt,
        camera=JCamera(),
    )


MEDIA = {
    "absorbing": (dict(sigma_a=(0.5, 1.0, 2.0)), 8, 3),
    "isotropic": (dict(sigma_s=(2.0, 2.0, 2.0)), 10, 4),
    "forward": (dict(sigma_s=(3.0, 3.0, 3.0), bias=0.9), 20, 16),
    "coloured": (dict(sigma_a=(0.05, 0.2, 0.4), sigma_s=(1.5, 1.0, 0.6), bias=0.4, ior=1.33), 10, 4),
}


def _jax_intersectors(tris, bvh=None):
    """The TPU plane kernels under ``interpret=True``, every closest-hit ray
    logged with its barycentrics (tmax, direction, t, u, v, prim)."""
    planes = JP.build_plane_table(tris)

    def closest(o, d, tn, tf):
        hit = JP.intersect_planes(o, d, planes, tris, tn, tf, interpret=True)
        jax.debug.callback(_jax_log("closest"), tf, d, hit.t, hit.u, hit.v, hit.prim, ordered=True)
        return hit

    def occluded(o, d, tn, tf):
        return JP.occluded_planes(o, d, planes, tn, tf, interpret=True)

    return closest, occluded


def _port_intersectors(make):
    def make_logging(tris, planes, bvh=None):
        closest, occluded = make(tris, planes, bvh)

        def closest_rec(o, d, tn, tf):
            hit = closest(o, d, tn, tf)
            _LOG["port"].append(("closest", [x.numpy().copy() for x in (tf, d, hit.t, hit.u, hit.v, hit.prim)]))
            return hit

        return closest_rec, occluded

    return make_logging


def _edge_plane_decisions(flipped):
    """The rays whose paths part on the plane z = 0 (a flipped hit, or
    directions more than ``DIR_APART`` apart) and those of them whose first
    parting is one of the plane's decisions: a hit on an edge (the nearer
    hit's barycentric coordinate within ``EDGE_BARY`` of 0), or a scatter
    from a direction that lies in the plane, its z a residue of opposite
    sign on the two sides (within ``EDGE_BARY`` of 0), so that the
    scattering frame (``utils/math.py::build_onb``, its sign taken from z) is
    mirrored."""
    calls = list(zip(*([a for _, a in _LOG[side] if a[0].shape[0] == N_RAYS] for side in ("jax", "port"))))
    parted = np.zeros(N_RAYS, bool)
    decided = np.zeros(N_RAYS, bool)
    for k, (j, p) in enumerate(calls):
        hit_flip = (j[0] > 0.0) & (p[0] > 0.0) & (j[-1] != p[-1])
        first = (hit_flip | (np.abs(j[1] - p[1]).max(axis=-1) > DIR_APART)) & ~parted
        near = np.where((j[2] <= p[2])[:, None], np.stack(j[3:5], -1), np.stack(p[3:5], -1))
        at_edge = hit_flip & (np.minimum(near.min(axis=-1), 1.0 - near.sum(axis=-1)) <= EDGE_BARY)
        mirrored = np.zeros(N_RAYS, bool)
        if k > 0:
            zj, zp = calls[k - 1][0][1][:, 2], calls[k - 1][1][1][:, 2]
            mirrored = (np.abs(zj) <= EDGE_BARY) & (np.abs(zp) <= EDGE_BARY) & (np.sign(zj) != np.sign(zp))
        decided |= first & (at_edge | mirrored)
        parted |= first
    assert not (flipped & ~parted).any()
    return parted, decided


def _trace(scene, max_depth, walk_length, height, seed=7):
    """Both packages' wavefronts over the same rays at z = ``height`` ->
    (JAX, port) outputs as numpy, the rays either side flipped, and those
    whose paths parted and of those the ones decided on the plane z = 0
    (``_edge_plane_decisions``)."""
    n = N_RAYS
    kw = dict(width=16, height=16, max_depth=max_depth, train=False, scene_epsilon=1e-4,
              walk_length=walk_length, direct_lighting=False, has_volumes=True)
    jcfg = JFrameConfig(render_mode=JRenderMode.NO_CACHE, **kw)
    pcfg = FrameConfig(render_mode=RenderMode.NO_CACHE, **kw)
    ys = np.linspace(-0.3, 0.3, n)
    org = np.stack([np.full(n, -3.0), ys, np.full(n, height)], -1).astype(np.float32)
    d = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    seeds = np.asarray(JR.tea(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(seed)))
    _LOG["jax"].clear()
    _LOG["port"].clear()
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)  # see test_torch_mlp.py
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_integrator, "make_intersectors", _jax_intersectors)
            mp.setattr(port_integrator, "make_intersectors", _port_intersectors(port_integrator.make_intersectors))
            jdev = jax_upload_scene(scene)
            jout = jax.jit(lambda o, dd, s: jax_integrator.trace_wavefront(jdev, o, dd, s, jcfg, train=False))(
                org, d, seeds)
            jout = {k: np.asarray(v) for k, v in jout._asdict().items()}
            jax.effects_barrier()
            pout = port_integrator.trace_wavefront(upload_scene(scene, "cpu"), torch.from_numpy(org),
                                                   torch.from_numpy(d), torch.from_numpy(seeds.astype(np.int64)),
                                                   pcfg)
    finally:
        jax.config.update("jax_enable_compilation_cache", prev)
    pout = {k: v.numpy() for k, v in pout._asdict().items() if v is not None}
    flipped = _flipped(_LOG["jax"], _LOG["port"], n)
    return jout, pout, flipped, *_edge_plane_decisions(flipped)


@pytest.mark.parametrize("height", list(HEIGHTS))
@pytest.mark.parametrize("medium", list(MEDIA))
def test_volume_wavefront_matches_jax(medium, height):
    coeffs, max_depth, walk_length = MEDIA[medium]
    z = HEIGHTS[height]
    jout, pout, flipped, parted, decided = _trace(sphere_scene(**coeffs), max_depth, walk_length, z)
    keep = ~parted
    if z == 0.0:
        # readings: 99-156 of the 256 rays part, each first at an edge but 34 of
        # the coloured medium's 140, which part at a mirrored scattering frame;
        # the kept rays' radiance 7.2e-7 relative at most
        assert np.array_equal(decided, parted), np.flatnonzero(parted & ~decided)
    else:
        # readings: no ray flipped, radiance 1.4e-6 relative at most, in all four
        assert flipped.mean() <= LIMITS["flipped_share"]
    for key in ("bounce_count", "traced_count"):
        assert np.array_equal(pout[key][keep], jout[key][keep].astype(pout[key].dtype)), key
    rad_j, rad_p = jout["radiance"], pout["radiance"]
    assert np.isfinite(rad_p).all() and rad_p.max() > 0.0
    rel = (np.abs(rad_p - rad_j) / np.maximum(np.abs(rad_j), 1e-3)).max(axis=-1)
    assert rel[keep].max() <= LIMITS["radiance_rel"], rel[keep].max()
    if medium == "absorbing":
        # Beer-Lambert through the kept ray nearest the middle: exp(-sigma_a L),
        # L = 2 sqrt(1 - y^2 - z^2)
        i = np.flatnonzero(keep)[np.abs(np.flatnonzero(keep) - N_RAYS // 2).argmin()]
        y = np.linspace(-0.3, 0.3, N_RAYS)[i]
        chord = 2 * np.sqrt(1 - y * y - z * z)
        np.testing.assert_allclose(rad_p[i], np.exp(-np.asarray([0.5, 1.0, 2.0]) * chord), rtol=0.02)
    else:  # the walk scattered: more work events than the two boundary hits
        assert (pout["bounce_count"] > 2).mean() > 0.5
