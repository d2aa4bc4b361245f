"""Procedural triangle geometry (NumPy): plane, box, affine transform.

Port of the builders of ``nrc_tpu/scene/geometry.py`` that the built-in
Cornell box uses, with the reference's conventions:
- plane: [-1,1]^2 quad tessellated tessU x tessV, normal along upAxis
  (``nrc/src/Plane.cpp:35-120``)
- box: unit cube [-1,1]^3, 12 triangles (``nrc/src/Box.cpp:35``)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray   # [V, 3] float32
    normals: np.ndarray    # [V, 3] float32
    tangents: np.ndarray   # [V, 3] float32
    texcoords: np.ndarray  # [V, 2] float32
    indices: np.ndarray    # [F, 3] uint32

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0])


def _grid_indices(tess_u: int, tess_v: int) -> np.ndarray:
    stride = tess_u + 1
    j, i = np.meshgrid(np.arange(tess_v), np.arange(tess_u), indexing="ij")
    a = j * stride + i
    b = j * stride + i + 1
    c = (j + 1) * stride + i + 1
    d = (j + 1) * stride + i
    tri1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    tri2 = np.stack([c, d, a], axis=-1).reshape(-1, 3)
    out = np.empty((tri1.shape[0] * 2, 3), dtype=np.uint32)
    out[0::2] = tri1
    out[1::2] = tri2
    return out


def create_plane(tess_u: int, tess_v: int, up_axis: int) -> Mesh:
    u = np.linspace(0.0, 2.0, tess_u + 1, dtype=np.float32)
    v = np.linspace(0.0, 2.0, tess_v + 1, dtype=np.float32)
    vv, uu = np.meshgrid(v, u, indexing="ij")
    n = (tess_u + 1) * (tess_v + 1)
    if up_axis == 0:  # +x normal, geometry on yz-plane
        corner = np.array([0.0, -1.0, 1.0], dtype=np.float32)
        verts = corner + np.stack([np.zeros_like(uu), vv, -uu], axis=-1)
        normal, tangent = (1.0, 0.0, 0.0), (0.0, 0.0, -1.0)
    elif up_axis == 1:  # +y normal, geometry on xz-plane
        corner = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
        verts = corner + np.stack([uu, np.zeros_like(uu), -vv], axis=-1)
        normal, tangent = (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)
    else:  # +z normal, geometry on xy-plane
        corner = np.array([-1.0, -1.0, 0.0], dtype=np.float32)
        verts = corner + np.stack([uu, vv, np.zeros_like(uu)], axis=-1)
        normal, tangent = (0.0, 0.0, 1.0), (1.0, 0.0, 0.0)
    tex = np.stack([uu * 0.5, vv * 0.5], axis=-1).reshape(-1, 2)
    return Mesh(
        vertices=verts.reshape(-1, 3).astype(np.float32),
        normals=np.tile(np.asarray(normal, np.float32), (n, 1)),
        tangents=np.tile(np.asarray(tangent, np.float32), (n, 1)),
        texcoords=tex.astype(np.float32),
        indices=_grid_indices(tess_u, tess_v),
    )


def create_box() -> Mesh:
    # Six faces of the [-1,1]^3 cube, each 4 verts + 2 tris, outward normals.
    faces = [
        # (normal, tangent, corner vertices in CCW order seen from outside)
        ((-1, 0, 0), (0, 0, 1), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)]),
        ((1, 0, 0), (0, 0, -1), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)]),
        ((0, -1, 0), (1, 0, 0), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)]),
        ((0, 1, 0), (1, 0, 0), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)]),
        ((0, 0, -1), (-1, 0, 0), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
        ((0, 0, 1), (1, 0, 0), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
    ]
    verts, normals, tangents, tex, idx = [], [], [], [], []
    uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for f, (n, t, corners) in enumerate(faces):
        base = f * 4
        for k, c in enumerate(corners):
            verts.append(c)
            normals.append(n)
            tangents.append(t)
            tex.append(uv[k])
        idx += [(base, base + 1, base + 2), (base + 2, base + 3, base)]
    return Mesh(
        vertices=np.asarray(verts, np.float32),
        normals=np.asarray(normals, np.float32),
        tangents=np.asarray(tangents, np.float32),
        texcoords=np.asarray(tex, np.float32),
        indices=np.asarray(idx, np.uint32),
    )


def transform_mesh(mesh: Mesh, matrix: np.ndarray) -> Mesh:
    """Apply a 4x4 affine transform; normals via inverse-transpose."""
    r = matrix[:3, :3]
    t = matrix[:3, 3]
    verts = mesh.vertices @ r.T + t
    nrm_mat = np.linalg.inv(r).T
    normals = mesh.normals @ nrm_mat.T
    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(norms, 1e-20)
    tangents = mesh.tangents @ r.T
    tnorm = np.linalg.norm(tangents, axis=-1, keepdims=True)
    tangents = tangents / np.maximum(tnorm, 1e-20)
    return Mesh(
        verts.astype(np.float32),
        normals.astype(np.float32),
        tangents.astype(np.float32),
        mesh.texcoords,
        mesh.indices,
    )
