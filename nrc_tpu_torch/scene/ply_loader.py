"""Stanford PLY loader -> Mesh (ascii + binary little/big endian).

The port's copy of ``nrc_tpu/scene/ply_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Extends the mesh-import path that stands in for the reference's Assimp
importer (``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``) to
the PLY format the classic scan models (bunny, dragon, ...) ship in.
Supports vertex properties x/y/z, nx/ny/nz, u/v (or s/t), and arbitrary
list-typed face indices (polygons fan-triangulated). Unknown properties
are skipped; normals are generated from face geometry when absent.
"""

from __future__ import annotations

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ---------------------------------------------------------
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")

    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, idx_dtype)])
    for line in header[1:]:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append((tok[4], _TYPES[tok[3]], True, _TYPES[tok[2]]))
            else:
                elements[-1][2].append((tok[2], _TYPES[tok[1]], False, None))

    if fmt is None:
        raise ValueError(f"{path}: missing PLY format line")
    swap = "" if fmt == "ascii" else ("<" if "little" in fmt else ">")

    verts = norms = uvs = None
    faces: list[tuple] = []

    if fmt == "ascii":
        lines = body.decode("ascii", errors="replace").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                while li < len(lines) and not lines[li].strip():
                    li += 1
                rows.append(lines[li].split())
                li += 1
            if name == "vertex":
                cols = {p[0]: i for i, p in enumerate(props)}
                arr = np.asarray(rows, np.float64)
                verts = arr[:, [cols["x"], cols["y"], cols["z"]]]
                if "nx" in cols:
                    norms = arr[:, [cols["nx"], cols["ny"], cols["nz"]]]
                for ux, vx in (("u", "v"), ("s", "t")):
                    if ux in cols and vx in cols:
                        uvs = arr[:, [cols[ux], cols[vx]]]
                        break
            elif name == "face":
                for row in rows:
                    n = int(row[0])
                    idx = [int(x) for x in row[1 : 1 + n]]
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
    else:
        off = 0
        for name, count, props in elements:
            if not any(p[2] for p in props):
                # fixed-size element: one structured read
                dt = np.dtype([(p[0], swap + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                if name == "vertex":
                    fields = arr.dtype.names
                    verts = np.stack(
                        [arr["x"], arr["y"], arr["z"]], -1
                    ).astype(np.float64)
                    if "nx" in fields:
                        norms = np.stack(
                            [arr["nx"], arr["ny"], arr["nz"]], -1
                        ).astype(np.float64)
                    for ux, vx in (("u", "v"), ("s", "t")):
                        if ux in fields and vx in fields:
                            uvs = np.stack([arr[ux], arr[vx]], -1).astype(
                                np.float64
                            )
                            break
            else:
                # list property (faces): parse per row
                cdt = np.dtype(swap + props[0][3])
                idt = np.dtype(swap + props[0][1])
                for _ in range(count):
                    n = int(np.frombuffer(body, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idx = np.frombuffer(body, idt, n, off)
                    off += idt.itemsize * n
                    if name == "face":
                        for k in range(1, n - 1):
                            faces.append(
                                (int(idx[0]), int(idx[k]), int(idx[k + 1]))
                            )

    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.uint32).reshape(-1, 3)
    n = (
        np.asarray(norms, np.float32)
        if norms is not None
        else generate_normals(v, f)
    )
    t = np.zeros_like(v) if uvs is None else None
    uv = (
        np.asarray(uvs, np.float32)
        if uvs is not None
        else np.zeros((v.shape[0], 2), np.float32)
    )
    tan = generate_tangents(v, n, uv, f)
    return Mesh(vertices=v, normals=n, tangents=tan, texcoords=uv, indices=f)
