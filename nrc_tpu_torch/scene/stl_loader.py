"""STL loader -> Mesh (binary + ascii).

The port's copy of ``nrc_tpu/scene/stl_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Another format of the mesh-import path standing in for the reference's
Assimp importer (``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``).
STL stores independent triangles with a facet normal and no UVs/indices;
vertices are welded by exact position so smooth normals can be generated
from the shared topology (facet normals are frequently garbage in the
wild, so they are only used as a fallback for degenerate fans).
"""

from __future__ import annotations

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents


def _parse_ascii(text: str, path: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        tok = line.split()
        if tok and tok[0] == "vertex":
            if len(tok) < 4:
                raise ValueError(f"{path}: malformed vertex line {line!r}")
            verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
    tri = np.asarray(verts, np.float32)
    if tri.size == 0 or tri.shape[0] % 3:
        raise ValueError(f"{path}: ascii STL vertex count {tri.shape[0]}")
    return tri.reshape(-1, 3, 3)


def _parse_binary(data: bytes, path: str) -> np.ndarray:
    if len(data) < 84:
        raise ValueError(f"{path}: binary STL too short")
    n = int(np.frombuffer(data, "<u4", 1, 80)[0])
    need = 84 + n * 50
    if len(data) < need:
        raise ValueError(f"{path}: binary STL truncated ({len(data)} < {need})")
    rec = np.frombuffer(data, np.uint8, n * 50, 84).reshape(n, 50)
    tri = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
    return tri.astype(np.float32)


def load_stl(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    # "solid" prefix alone does not imply ascii (many binary exporters use
    # it); ascii files contain the "facet" keyword in the first chunk
    head = data[:512].decode("ascii", errors="replace").lower()
    if head.startswith("solid") and "facet" in head:
        tri = _parse_ascii(data.decode("ascii", errors="replace"), path)
    else:
        tri = _parse_binary(data, path)

    # weld identical positions into shared vertices for smooth normals
    flat = tri.reshape(-1, 3)
    uniq, inv = np.unique(flat.round(decimals=6), axis=0, return_inverse=True)
    # representative (un-rounded) position per welded vertex
    first = np.zeros(uniq.shape[0], np.int64)
    first[inv[::-1]] = np.arange(flat.shape[0] - 1, -1, -1)
    v = flat[first].astype(np.float32)
    f = inv.reshape(-1, 3).astype(np.uint32)
    # drop degenerate triangles produced by welding
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[keep]
    n = generate_normals(v, f)
    uv = np.zeros((v.shape[0], 2), np.float32)
    tan = generate_tangents(v, n, uv, f)
    return Mesh(vertices=v, normals=n, tangents=tan, texcoords=uv, indices=f)
