"""Port parity for the mesh importers of ``model assimp``.

Each loader in ``nrc_tpu_torch/scene/*_loader.py`` is the JAX package's
numpy code, so a file must give the same ``Mesh`` arrays (vertices,
normals, tangents, texcoords, indices) bit for bit, with the same dtypes
and shapes. One test, parametrised over the formats: OBJ (quads,
negative indices, missing normals), PLY (ascii, binary little and big
endian), STL (ascii and binary), glTF with a data URI and GLB, COLLADA
(triangles and polylist under node transforms), FBX (binary, binary with
zlib-compressed arrays, ascii with a model transform) and 3DS. The files
are written under ``tmp_path`` from a seeded bumpy grid, some through the
writers of the JAX package's own loader tests. A second test holds the
port's ``make_mesh`` dispatch by extension to the JAX ``_make_mesh``.
"""

import base64
import json
import struct
import types

import numpy as np
import pytest

from nrc_tpu.scene import dae_loader as JDAE
from nrc_tpu.scene import fbx_loader as JFBX
from nrc_tpu.scene import gltf_loader as JGLTF
from nrc_tpu.scene import obj_loader as JOBJ
from nrc_tpu.scene import ply_loader as JPLY
from nrc_tpu.scene import scene_builder as JSB
from nrc_tpu.scene import stl_loader as JSTL
from nrc_tpu.scene import tds_loader as JTDS
from nrc_tpu_torch.scene import dae_loader as PDAE
from nrc_tpu_torch.scene import fbx_loader as PFBX
from nrc_tpu_torch.scene import gltf_loader as PGLTF
from nrc_tpu_torch.scene import obj_loader as POBJ
from nrc_tpu_torch.scene import ply_loader as PPLY
from nrc_tpu_torch.scene import scene_builder as PSB
from nrc_tpu_torch.scene import stl_loader as PSTL
from nrc_tpu_torch.scene import tds_loader as PTDS
from test_3ds import _3ds
from test_dae import DAE, POLYLIST
from test_fbx import ASCII_DOC, _binary_fbx
from test_stl import _binary_stl

MESH_FIELDS = ("vertices", "normals", "tangents", "texcoords", "indices")


def grid(nu=5, nv=4, seed=16):
    """A bumpy (nu x nv)-vertex grid: float32 positions, unit normals, uvs,
    and its quads as (a, b, c, d) corner indices."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    pos = np.stack([u * 3.0, v * 2.0, rng.normal(0.0, 0.2, u.shape)], -1).reshape(-1, 3).astype(np.float32)
    nrm = rng.normal(size=(nu * nv, 3)) + [0.0, 0.0, 3.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    k = np.arange(nu * nv).reshape(nu, nv)
    quads = np.stack([k[:-1, :-1], k[1:, :-1], k[1:, 1:], k[:-1, 1:]], -1).reshape(-1, 4)
    return pos, nrm, uv, quads


def triangles(quads):
    return np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])


def f(x):
    return repr(float(x))


def write_obj(path):
    pos, nrm, uv, quads = grid()
    lines = ["# a comment", "o grid"] + [f"v {f(a)} {f(b)} {f(c)}" for a, b, c in pos]
    lines += [f"vt {f(a)} {f(b)}" for a, b in uv] + [f"vn {f(a)} {f(b)} {f(c)}" for a, b, c in nrm]
    n = len(pos)
    for i, q in enumerate(quads):
        if i % 3 == 0:    # a quad with every attribute
            lines.append("f " + " ".join(f"{j + 1}/{j + 1}/{j + 1}" for j in q))
        elif i % 3 == 1:  # negative indices, no normals: generated
            lines.append("f " + " ".join(f"{j - n}/{j - n}" for j in q[:3]))
        else:             # positions and normals only
            lines.append("f " + " ".join(f"{j + 1}//{j + 1}" for j in q[[0, 2, 3]]))
    path.write_text("\n".join(lines) + "\n")


PLY_PROPS = ("x", "y", "z", "nx", "ny", "nz", "u", "v")


def ply_header(fmt, n, nf, extra=""):
    props = "".join(f"property float {p}\n" for p in PLY_PROPS)
    return (f"ply\nformat {fmt} 1.0\ncomment seeded grid\nelement vertex {n}\n{props}{extra}"
            f"element face {nf}\nproperty list uchar int vertex_indices\nend_header\n")


def write_ply(path, fmt):
    pos, nrm, uv, quads = grid()
    rows = np.concatenate([pos, nrm, uv], -1)
    faces = [list(q) for q in quads[::2]] + [list(q[:3]) for q in quads[1::2]]
    if fmt == "ascii":
        body = "".join(" ".join(f(x) for x in r) + " 7\n" for r in rows)
        body += "".join(f"{len(fc)} " + " ".join(map(str, fc)) + "\n" for fc in faces)
        path.write_text(ply_header("ascii", len(rows), len(faces), "property uchar flag\n") + body)
        return
    e = "<" if fmt == "binary_little_endian" else ">"
    body = b"".join(struct.pack(f"{e}8f", *r) for r in rows)
    body += b"".join(struct.pack(f"{e}B{len(fc)}i", len(fc), *fc) for fc in faces)
    path.write_bytes(ply_header(fmt, len(rows), len(faces)).encode() + body)


def stl_triangles():
    pos, _, _, quads = grid()
    return [[tuple(map(float, pos[j])) for j in t] for t in triangles(quads)]


def write_stl_ascii(path):
    lines = ["solid grid"]
    for t in stl_triangles():
        lines.append(" facet normal 0 0 1\n  outer loop")
        lines += [f"   vertex {f(v[0])} {f(v[1])} {f(v[2])}" for v in t]
        lines.append("  endloop\n endfacet")
    path.write_text("\n".join(lines + ["endsolid grid"]) + "\n")


def gltf_doc():
    """A document of the grid (positions, normals, uvs, u32 indices) under
    a node with translation, rotation and scale, and its buffer."""
    pos, nrm, uv, quads = grid()
    idx = triangles(quads).astype(np.uint32).ravel()
    parts = [pos.tobytes(), nrm.tobytes(), uv.tobytes(), idx.tobytes()]
    offs = np.cumsum([0] + [len(p) for p in parts])
    views = [{"buffer": 0, "byteOffset": int(o), "byteLength": len(p)} for o, p in zip(offs, parts)]
    acc = [{"bufferView": 0, "componentType": 5126, "count": len(pos), "type": "VEC3"},
           {"bufferView": 1, "componentType": 5126, "count": len(pos), "type": "VEC3"},
           {"bufferView": 2, "componentType": 5126, "count": len(pos), "type": "VEC2"},
           {"bufferView": 3, "componentType": 5125, "count": len(idx), "type": "SCALAR"}]
    q = np.array([0.1, 0.2, 0.3, 0.9])
    node = {"mesh": 0, "translation": [1.0, -2.0, 0.5], "rotation": list(q / np.linalg.norm(q)),
            "scale": [2.0, 1.0, 0.5]}
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [node],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                                       "indices": 3}]}],
           "accessors": acc, "bufferViews": views, "buffers": [{"byteLength": int(offs[-1])}]}
    return doc, b"".join(parts)


def write_gltf(path):
    doc, buf = gltf_doc()
    doc["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(buf).decode()
    path.write_text(json.dumps(doc))


def write_glb(path):
    doc, buf = gltf_doc()
    jdata = json.dumps(doc).encode()
    jdata += b" " * (-len(jdata) % 4)
    buf += b"\x00" * (-len(buf) % 4)
    path.write_bytes(struct.pack("<3I", 0x46546C67, 2, 12 + 8 + len(jdata) + 8 + len(buf))
                     + struct.pack("<2I", len(jdata), 0x4E4F534A) + jdata
                     + struct.pack("<2I", len(buf), 0x004E4942) + buf)


def write_dae(path, prim):
    xf = ('<translate>1 2 3</translate><rotate>0 1 0 30</rotate><scale>2 2 1</scale>'
          '<node id="inner"><rotate>1 0 0 45</rotate><instance_geometry url="#quad"/></node>')
    if prim == "triangles":
        pos, nrm, _, quads = grid()
        tri = triangles(quads)
        p = " ".join(f"{a} {a}" for a in tri.ravel())
        text = (DAE.replace('count="12">\n            0 0 0  1 0 0  1 1 0  0 1 0',
                            f'count="{pos.size}">' + " ".join(map(f, pos.ravel())))
                .replace('<accessor source="#quad-pos-array" count="4"', f'<accessor source="#quad-pos-array" count="{len(pos)}"')
                .replace('count="3">0 0 1</float_array>', f'count="{nrm.size}">' + " ".join(map(f, nrm.ravel())) + "</float_array>")
                .replace('<accessor source="#quad-nrm-array" count="1"', f'<accessor source="#quad-nrm-array" count="{len(nrm)}"')
                .replace("{PRIM}", f'<triangles count="{len(tri)}"><input semantic="VERTEX" source="#quad-verts" offset="0"/>'
                                   f'<input semantic="NORMAL" source="#quad-nrm" offset="1"/><p>{p}</p></triangles>'))
    else:
        text = DAE.replace("{PRIM}", POLYLIST)
    path.write_text(text.replace("{XF}", xf))


def write_fbx(path, kind):
    if kind == "ascii":
        path.write_text(ASCII_DOC.replace('"A",2,2,2', '"A",2,3,4') + "\n")
        return
    pos, _, _, quads = grid()
    idx = []
    for q in quads:  # polygons end with the xor'd last index
        idx += [int(q[0]), int(q[1]), int(q[2]), ~int(q[3])]
    path.write_bytes(_binary_fbx(pos.astype(np.float64).ravel().tolist(), idx, compress=kind == "compressed"))


def write_3ds(path):
    pos, _, uv, quads = grid()
    path.write_bytes(_3ds([tuple(map(float, p)) for p in pos], [tuple(map(int, t)) for t in triangles(quads)],
                          [tuple(map(float, u)) for u in uv]))


CASES = {
    "obj": ("grid.obj", write_obj, POBJ.load_obj, JOBJ.load_obj),
    "ply_ascii": ("grid.ply", lambda p: write_ply(p, "ascii"), PPLY.load_ply, JPLY.load_ply),
    "ply_binary_le": ("grid.ply", lambda p: write_ply(p, "binary_little_endian"), PPLY.load_ply, JPLY.load_ply),
    "ply_binary_be": ("grid.ply", lambda p: write_ply(p, "binary_big_endian"), PPLY.load_ply, JPLY.load_ply),
    "stl_ascii": ("grid.stl", write_stl_ascii, PSTL.load_stl, JSTL.load_stl),
    "stl_binary": ("grid.stl", lambda p: p.write_bytes(_binary_stl(stl_triangles(), b"solid but binary")),
                   PSTL.load_stl, JSTL.load_stl),
    "gltf": ("grid.gltf", write_gltf, PGLTF.load_gltf, JGLTF.load_gltf),
    "glb": ("grid.glb", write_glb, PGLTF.load_gltf, JGLTF.load_gltf),
    "dae_triangles": ("grid.dae", lambda p: write_dae(p, "triangles"), PDAE.load_dae, JDAE.load_dae),
    "dae_polylist": ("quad.dae", lambda p: write_dae(p, "polylist"), PDAE.load_dae, JDAE.load_dae),
    "fbx_binary": ("grid.fbx", lambda p: write_fbx(p, "binary"), PFBX.load_fbx, JFBX.load_fbx),
    "fbx_compressed": ("grid.fbx", lambda p: write_fbx(p, "compressed"), PFBX.load_fbx, JFBX.load_fbx),
    "fbx_ascii": ("quad.fbx", lambda p: write_fbx(p, "ascii"), PFBX.load_fbx, JFBX.load_fbx),
    "3ds": ("grid.3ds", write_3ds, PTDS.load_3ds, JTDS.load_3ds),
}


def same_mesh(a, b):
    for k in MESH_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_equals_jax_bit_for_bit(tmp_path, case):
    name, write, load, jload = CASES[case]
    path = tmp_path / name
    write(path)
    mesh, jmesh = load(str(path)), jload(str(path))
    same_mesh(mesh, jmesh)
    assert mesh.indices.shape[0] >= 2 and np.isfinite(mesh.vertices).all()
    # the scene builders' dispatch by extension reads it the same way
    decl = PSB.ModelDecl("assimp", np.eye(4), "", path=str(path))
    same_mesh(PSB.make_mesh(decl), JSB._make_mesh(types.SimpleNamespace(kind="assimp", path=str(path))))


def test_make_mesh_procedural_and_unknown_kinds():
    """The procedural kinds equal the JAX ``_make_mesh``; an unknown kind
    raises ``ValueError`` in both (and ``build_scene`` drops the model)."""
    for kind, args in (("plane", (3, 2, 1)), ("box", ()), ("sphere", (8, 4, 0.5)), ("torus", (6, 5, 0.25, 1.5))):
        decl = PSB.ModelDecl(kind, np.eye(4), "", args)
        same_mesh(PSB.make_mesh(decl), JSB._make_mesh(types.SimpleNamespace(kind=kind, args=args)))
    with pytest.raises(ValueError, match="cylinder"):
        PSB.make_mesh(PSB.ModelDecl("cylinder", np.eye(4)))
    with pytest.raises(ValueError, match="cylinder"):
        JSB._make_mesh(types.SimpleNamespace(kind="cylinder"))
