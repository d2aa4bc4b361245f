"""Device texture lookups: software bilinear fetches from the texture atlas.

Port of ``nrc_tpu/ops/texture.py``; the reference samples CUDA texture
objects through the MDL texture runtime (``tex_lookup_float4_2d``,
``nrc/shaders/texture_lookup.h``): wrap-repeat addressing, bilinear
filtering, here as row gathers from the flat atlas
(``scene/texture.py``). On the renderer's atlas every texel row carries its
2x2 wrap-neighbour window (``texels_quad``, 16 floats), so a bilinear
fetch is ONE row gather through ``gather_rows`` (K7 on the card). A raw
host atlas without it takes the four-corner fetch: the renderer never does
(``device_arrays`` always builds the quad rows); that path is there only to
hold the fetch against the JAX package's raw-atlas lookup
(``tests/test_torch_textures.py``).

A ``tex_id`` of -1 reads white (1, 1, 1, 1), so material code multiplies
unconditionally.

Cube environments: ``cube_face_uv`` / ``cube_dir_from_face_uv`` map
directions to and from (face, u, v) in the D3D/CUDA cube convention, and
``sample_cube_env`` is a bilinear fetch clamped within a face.
"""

from __future__ import annotations

import torch

from .gather_cuda import gather_rows


def _wrap(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    # wrap_repeat (the MDL default): floored modulo
    return torch.remainder(i, torch.clamp(n, min=1))


def sample_bilinear(atlas: dict, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear RGBA fetch from a texture's first level. ``tex_id`` [N]
    integer (-1 = none), ``uv`` [N, 2]. Returns [N, 4]. The quad-row path
    where the atlas has ``texels_quad`` (the renderer's), else the
    four-corner path (raw atlases in the tests)."""
    has = tex_id >= 0
    li = atlas["tex_level_base"][torch.clamp(tex_id, min=0).to(torch.int64)]
    w = atlas["level_w"][li]
    h = atlas["level_h"][li]
    off = atlas["level_offset"][li]

    x = uv[:, 0] * w.to(torch.float32) - 0.5
    y = uv[:, 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    ix0 = _wrap(x0.to(torch.int64), w)
    iy0 = _wrap(y0.to(torch.int64), h)

    if "texels_quad" in atlas:
        idx = torch.where(has, off + iy0 * w + ix0, 0)  # texel 0 = white
        q = gather_rows(atlas["texels_quad"], idx)      # [N, 16]
        c00, c01, c10, c11 = q[:, 0:4], q[:, 4:8], q[:, 8:12], q[:, 12:16]
    else:
        tx = atlas["texels"]
        ix1 = _wrap(ix0 + 1, w)
        iy1 = _wrap(iy0 + 1, h)

        def fetch(iy, ix):
            return tx[torch.where(has, off + iy * w + ix, 0)]

        c00, c01, c10, c11 = fetch(iy0, ix0), fetch(iy0, ix1), fetch(iy1, ix0), fetch(iy1, ix1)
    out = (
        c00 * (1.0 - fx) * (1.0 - fy)
        + c01 * fx * (1.0 - fy)
        + c10 * (1.0 - fx) * fy
        + c11 * fx * fy
    )
    return torch.where(has[:, None], out, 1.0)


def apply_uv_transform(uv: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """MDL ``base::rotation_translation_scale`` in the uv plane (rotation
    about w): uv' = R(rot_z) @ (uv * scale) + translation. ``xf`` rows:
    [scale_u, scale_v, trans_u, trans_v, cos_rz, sin_rz]."""
    s = uv * xf[:, 0:2]
    c, sn = xf[:, 4], xf[:, 5]
    u = c * s[:, 0] - sn * s[:, 1]
    v = sn * s[:, 0] + c * s[:, 1]
    return torch.stack([u, v], dim=-1) + xf[:, 2:4]


def cube_face_uv(direction: torch.Tensor):
    """Direction [N, 3] -> (face [N] i64, u [N], v [N]), faces ordered
    +X -X +Y -Y +Z -Z; for the major axis m, |m| the largest component:
      +X: u=-z/|x|, v=-y/|x|    -X: u= z/|x|, v=-y/|x|
      +Y: u= x/|y|, v= z/|y|    -Y: u= x/|y|, v=-z/|y|
      +Z: u= x/|z|, v=-y/|z|    -Z: u=-x/|z|, v=-y/|z|
    mapped to [0, 1]^2 (v runs top-down like image rows)."""
    x, y, z = direction[:, 0], direction[:, 1], direction[:, 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-20)
    sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                     torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    )
    return face, (sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5


def cube_dir_from_face_uv(face: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The inverse of ``cube_face_uv``: (face, u, v in [0, 1]) -> unit
    direction [N, 3]."""
    sc = u * 2.0 - 1.0
    tc = v * 2.0 - 1.0
    one = torch.ones_like(sc)
    # per face (x, y, z) as functions of (sc, tc); columns are faces 0..5
    xs = torch.stack([one, -one, sc, sc, sc, -sc], dim=-1)
    ys = torch.stack([-tc, -tc, one, -one, -tc, -tc], dim=-1)
    zs = torch.stack([-sc, sc, tc, -tc, one, -one], dim=-1)
    oh = face[:, None] == torch.arange(6, device=face.device)
    d = torch.stack([torch.where(oh, c, 0.0).sum(dim=-1) for c in (xs, ys, zs)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def sample_cube_env(cube: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch from a dense [6, H, W, C] face stack by direction
    [N, 3] -> [N, C]. Filtering clamps within the face (no bleeding across
    faces, as clamped CUDA array layers)."""
    _, h, w, ch = cube.shape
    face, u, v = cube_face_uv(direction)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    ix0 = torch.clamp(x0.to(torch.int64), 0, w - 1)
    iy0 = torch.clamp(y0.to(torch.int64), 0, h - 1)
    ix1 = torch.clamp(ix0 + 1, 0, w - 1)
    iy1 = torch.clamp(iy0 + 1, 0, h - 1)
    flat = cube.reshape(-1, ch)
    base = face * (h * w)

    def fetch(iy, ix):
        return flat[base + iy * w + ix]

    return (
        fetch(iy0, ix0) * (1.0 - fx) * (1.0 - fy)
        + fetch(iy0, ix1) * fx * (1.0 - fy)
        + fetch(iy1, ix0) * (1.0 - fx) * fy
        + fetch(iy1, ix1) * fx * fy
    )
