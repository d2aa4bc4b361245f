"""Wavefront OBJ loader -> Mesh.

The port's copy of ``nrc_tpu/scene/obj_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Stands in for the reference's Assimp import path
(``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``) for the
common OBJ case: positions, normals (generated if missing), texcoords,
triangulated faces (fans for polygons).
"""

from __future__ import annotations

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents


def load_obj(path: str) -> Mesh:
    positions: list[tuple] = []
    normals: list[tuple] = []
    texcoords: list[tuple] = []
    # output vertex stream (deduplicated per (v, vt, vn) triple)
    out_v: list[int] = []
    vert_map: dict[tuple, int] = {}
    out_pos: list[tuple] = []
    out_nrm: list[tuple] = []
    out_tex: list[tuple] = []
    faces: list[tuple] = []

    def vertex(spec: str) -> int:
        key = spec
        if key in vert_map:
            return vert_map[key]
        parts = spec.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = -1
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(texcoords) + t
        if len(parts) > 2 and parts[2]:
            n = int(parts[2])
            ni = n - 1 if n > 0 else len(normals) + n
        idx = len(out_pos)
        out_pos.append(positions[vi])
        out_tex.append(texcoords[ti] if ti >= 0 else (0.0, 0.0))
        out_nrm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        vert_map[key] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                positions.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == "vn":
                normals.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == "vt":
                texcoords.append((float(t[1]), float(t[2])))
            elif t[0] == "f":
                idx = [vertex(s) for s in t[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    pos = np.asarray(out_pos, np.float32).reshape(-1, 3)
    nrm = np.asarray(out_nrm, np.float32).reshape(-1, 3)
    tex = np.asarray(out_tex, np.float32).reshape(-1, 2)
    indices = np.asarray(faces, np.uint32).reshape(-1, 3)

    # Generate smooth normals where missing (area-weighted)
    missing = np.linalg.norm(nrm, axis=-1) < 1e-6
    if np.any(missing) and indices.size:
        nrm[missing] = generate_normals(pos, indices)[missing]

    t = generate_tangents(pos, nrm, tex, indices)
    return Mesh(pos, nrm, t, tex, indices)
