"""3D Studio (.3ds) mesh importer -> Mesh.

The port's copy of ``nrc_tpu/scene/tds_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Another format of the mesh-import path standing in for the reference's
Assimp importer (``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``).
The 3DS container is a tree of (u16 id, u32 length) chunks; this reads
MAIN(0x4D4D) > EDITOR(0x3D3D) > OBJECT(0x4000) > MESH(0x4100) with
VERTICES(0x4110), FACES(0x4120), UVs(0x4140), and the local-axis matrix
(0x4160). Faces are triangles already. No materials/keyframes.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents

MAIN = 0x4D4D
EDITOR = 0x3D3D
OBJECT = 0x4000
MESH = 0x4100
VERTICES = 0x4110
FACES = 0x4120
UVS = 0x4140
LOCAL_AXES = 0x4160


def load_3ds(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 6 or struct.unpack_from("<H", data, 0)[0] != MAIN:
        raise ValueError(f"{path}: not a 3DS file")

    all_v: List[np.ndarray] = []
    all_f: List[np.ndarray] = []
    all_uv: List[np.ndarray] = []
    base = 0

    def parse_mesh(off: int, end: int):
        nonlocal base
        verts = uv = None
        faces = None
        o = off
        while o + 6 <= end:
            cid, clen = struct.unpack_from("<HI", data, o)
            body = o + 6
            if cid == VERTICES:
                n = struct.unpack_from("<H", data, body)[0]
                verts = np.frombuffer(
                    data, "<f4", n * 3, body + 2
                ).reshape(n, 3).astype(np.float64)
            elif cid == FACES:
                n = struct.unpack_from("<H", data, body)[0]
                f4 = np.frombuffer(data, "<u2", n * 4, body + 2).reshape(n, 4)
                faces = f4[:, :3].astype(np.int64)
            elif cid == UVS:
                n = struct.unpack_from("<H", data, body)[0]
                uv = np.frombuffer(
                    data, "<f4", n * 2, body + 2
                ).reshape(n, 2).astype(np.float32)
            # LOCAL_AXES (0x4160) is deliberately skipped: 3ds exports store
            # vertices already world-placed, so re-applying the mesh matrix
            # would double-transform (matching Assimp's default)
            o += max(clen, 6)
        if verts is not None and faces is not None:
            all_v.append(verts)
            all_f.append(faces + base)
            all_uv.append(
                uv if uv is not None and uv.shape[0] == verts.shape[0] else None
            )
            base += verts.shape[0]

    def walk(off: int, end: int, depth: int = 0):
        o = off
        while o + 6 <= end:
            cid, clen = struct.unpack_from("<HI", data, o)
            if clen < 6:
                break
            body, cend = o + 6, min(o + clen, end)
            if cid in (MAIN, EDITOR):
                walk(body, cend, depth + 1)
            elif cid == OBJECT:
                # object name: NUL-terminated string before subchunks
                z = data.index(b"\0", body, cend)
                walk(z + 1, cend, depth + 1)
            elif cid == MESH:
                parse_mesh(body, cend)
            o += clen

    walk(0, len(data))
    if not all_v:
        raise ValueError(f"{path}: no mesh geometry found")
    v = np.concatenate(all_v).astype(np.float32)
    f = np.concatenate(all_f).astype(np.uint32)
    n = generate_normals(v, f)
    uv = (
        np.concatenate(all_uv).astype(np.float32)
        if all(u is not None for u in all_uv)
        else np.zeros((v.shape[0], 2), np.float32)
    )
    tan = generate_tangents(v, n, uv, f)
    return Mesh(vertices=v, normals=n, tangents=tan, texcoords=uv, indices=f)
