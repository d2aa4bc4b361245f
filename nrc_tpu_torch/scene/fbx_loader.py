"""Minimal FBX mesh importer (binary FBX 7.x and ASCII FBX) -> Mesh.

The port's copy of ``nrc_tpu/scene/fbx_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Another format of the mesh-import path standing in for the reference's
Assimp importer (``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``).
Scope: static geometry — Vertices / PolygonVertexIndex (fan-triangulated),
per-polygon-vertex or per-vertex normals and UVs, local Model TRS transforms
resolved through the Connections parent chain. No skinning, animation,
cameras, or materials.

Binary format: 'Kaydara FBX Binary' header; node records (u32 fields, or
u64 from version 7500) of (end_offset, num_props, prop_list_len, name);
typed properties incl. zlib-compressed arrays. ASCII format: a line-based
``Name: p1, p2 { children }`` grammar with ``a:`` number lists.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents

_BIN_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list):
        self.name = name
        self.props = props
        self.children: List["_Node"] = []

    def child(self, name: str) -> Optional["_Node"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str) -> List["_Node"]:
        return [c for c in self.children if c.name == name]


# ---------------------------------------------------------------------------
# binary parser
# ---------------------------------------------------------------------------

_SCALAR = {"Y": ("<h", 2), "C": ("<b", 1), "I": ("<i", 4),
           "F": ("<f", 4), "D": ("<d", 8), "L": ("<q", 8)}
_ARRAY = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4", "b": "u1"}


def _parse_binary(data: bytes) -> _Node:
    version = struct.unpack_from("<I", data, 23)[0]
    wide = version >= 7500  # u64 node-record fields
    word = "<QQQB" if wide else "<IIIB"
    word_size = struct.calcsize(word)

    def parse_props(off: int, count: int) -> Tuple[list, int]:
        out = []
        for _ in range(count):
            code = chr(data[off]); off += 1
            if code in _SCALAR:
                fmt, sz = _SCALAR[code]
                out.append(struct.unpack_from(fmt, data, off)[0])
                off += sz
            elif code in _ARRAY:
                n, enc, clen = struct.unpack_from("<3I", data, off)
                off += 12
                dt = np.dtype(_ARRAY[code])
                if enc == 0:
                    raw = data[off: off + n * dt.itemsize]
                    off += n * dt.itemsize
                else:
                    raw = zlib.decompress(data[off: off + clen])
                    off += clen
                out.append(np.frombuffer(raw, dt, n))
            elif code == "S":
                n = struct.unpack_from("<I", data, off)[0]
                off += 4
                out.append(data[off: off + n].decode("utf-8", "replace"))
                off += n
            elif code == "R":
                n = struct.unpack_from("<I", data, off)[0]
                off += 4
                out.append(data[off: off + n])
                off += n
            else:
                raise ValueError(f"FBX: unknown property type {code!r}")
        return out, off

    def parse_node(off: int) -> Tuple[Optional[_Node], int]:
        end, n_props, _plen, name_len = struct.unpack_from(word, data, off)
        off += word_size
        if end == 0:
            return None, off
        name = data[off: off + name_len].decode("ascii", "replace")
        off += name_len
        props, off = parse_props(off, n_props)
        node = _Node(name, props)
        while off < end:
            child, off = parse_node(off)
            if child is not None:
                node.children.append(child)
        return node, end

    root = _Node("", [])
    off = 27
    while off < len(data):
        node, off = parse_node(off)
        if node is None:
            break
        root.children.append(node)
    return root


# ---------------------------------------------------------------------------
# ascii parser
# ---------------------------------------------------------------------------

_NUM = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)$")


def _tok_value(tok: str):
    tok = tok.strip()
    if not tok:
        return None
    if tok.startswith('"'):
        return tok.strip('"')
    if _NUM.match(tok):
        return float(tok) if ("." in tok or "e" in tok or "E" in tok) else int(tok)
    return tok  # bare identifiers (T, Y, etc.)


def _parse_ascii(text: str) -> _Node:
    root = _Node("", [])
    stack = [root]
    cur_a: Optional[list] = None  # open `a:` numeric list (no own braces)
    _cont = re.compile(r"^[\d\s.,+\-eE]+,?$")
    for raw_line in text.splitlines():
        line = raw_line.split(";", 1)[0].strip()
        if not line:
            continue
        if cur_a is not None and _cont.match(line.rstrip("}").strip() or "x"):
            closes = line.endswith("}")
            body = line.rstrip("}").strip()
            if body:
                cur_a.extend(
                    v for v in (_tok_value(t) for t in body.split(","))
                    if isinstance(v, (int, float))
                )
            if closes:
                cur_a = None
                stack.pop()
            continue
        if line == "}":
            cur_a = None
            stack.pop()
            continue
        m = re.match(r"^([A-Za-z0-9_]+)\s*:\s*(.*)$", line)
        if not m:
            continue
        cur_a = None
        name, rest = m.group(1), m.group(2)
        opens = rest.endswith("{")
        if opens:
            rest = rest[:-1].strip()
        props = [
            v for v in (_tok_value(t) for t in rest.split(",")) if v is not None
        ] if rest else []
        node = _Node(name, props)
        stack[-1].children.append(node)
        if opens:
            stack.append(node)
        if name == "a":  # numeric list; may continue on following lines
            cur_a = node.props
    return root


def _coalesce_array(node: Optional[_Node]) -> Optional[np.ndarray]:
    """Array payload: binary = ndarray prop; ascii = child node 'a' numbers."""
    if node is None:
        return None
    for p in node.props:
        if isinstance(p, np.ndarray):
            return p
    a = node.child("a")
    if a is not None:
        return np.asarray([x for x in a.props if isinstance(x, (int, float))])
    nums = [x for x in node.props if isinstance(x, (int, float))]
    return np.asarray(nums) if nums else None


# ---------------------------------------------------------------------------
# scene extraction
# ---------------------------------------------------------------------------

def _euler_xyz(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx  # FBX default rotation order XYZ (applied X first)


def _model_local(model: _Node) -> np.ndarray:
    t = np.zeros(3)
    r = np.zeros(3)
    s = np.ones(3)
    p70 = model.child("Properties70") or model.child("Properties60")
    if p70 is not None:
        for p in p70.all("P") + p70.all("Property"):
            if not p.props:
                continue
            key = p.props[0]
            vals = [x for x in p.props if isinstance(x, (int, float))][-3:]
            if len(vals) != 3:
                continue
            if key == "Lcl Translation":
                t = np.asarray(vals, np.float64)
            elif key == "Lcl Rotation":
                r = np.deg2rad(np.asarray(vals, np.float64))
            elif key == "Lcl Scaling":
                s = np.asarray(vals, np.float64)
    m = np.eye(4)
    m[:3, :3] = _euler_xyz(*r) * s[None, :]
    m[:3, 3] = t
    return m


def load_fbx(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_BIN_MAGIC)] == _BIN_MAGIC:
        root = _parse_binary(data)
    else:
        root = _parse_ascii(data.decode("utf-8", "replace"))

    objects = root.child("Objects")
    if objects is None:
        raise ValueError(f"{path}: no Objects section")

    # id -> node maps + connections (child_id -> parent_id)
    geoms: Dict[int, _Node] = {}
    models: Dict[int, _Node] = {}
    for g in objects.all("Geometry"):
        gid = next((p for p in g.props if isinstance(p, (int, float))), 0)
        geoms[int(gid)] = g
    for mnode in objects.all("Model"):
        mid = next((p for p in mnode.props if isinstance(p, (int, float))), 0)
        models[int(mid)] = mnode
    parent: Dict[int, int] = {}
    conns = root.child("Connections")
    if conns is not None:
        for c in conns.all("C") + conns.all("Connect"):
            ids = [int(p) for p in c.props if isinstance(p, (int, float))]
            if len(ids) >= 2:
                parent[ids[0]] = ids[1]

    def world_of(gid: int) -> np.ndarray:
        m = np.eye(4)
        nid, seen = parent.get(gid, 0), 0
        while nid and nid in models and seen < 64:
            m = _model_local(models[nid]) @ m
            nid = parent.get(nid, 0)
            seen += 1
        return m

    all_v, all_f, all_n, all_uv = [], [], [], []
    base = 0
    for gid, g in geoms.items() or [(0, objects)]:
        verts = _coalesce_array(g.child("Vertices"))
        idx = _coalesce_array(g.child("PolygonVertexIndex"))
        if verts is None or idx is None:
            continue
        verts = np.asarray(verts, np.float64).reshape(-1, 3)
        idx = np.asarray(idx, np.int64)
        xf = world_of(gid)
        verts = verts @ xf[:3, :3].T + xf[:3, 3]

        # fan-triangulate: negative index marks polygon end (val = ~real)
        polys: List[List[int]] = []
        cur: List[int] = []
        for v in idx:
            if v < 0:
                cur.append(int(~v))
                polys.append(cur)
                cur = []
            else:
                cur.append(int(v))
        faces = []
        pv_of_face = []  # polygon-vertex index per triangle corner
        pv = 0
        for poly in polys:
            for k in range(1, len(poly) - 1):
                faces.append((poly[0], poly[k], poly[k + 1]))
                pv_of_face.append((pv, pv + k, pv + k + 1))
            pv += len(poly)
        f = np.asarray(faces, np.int64).reshape(-1, 3)

        # normals / uvs (optional; ByPolygonVertex needs vertex splitting —
        # keep it simple: average polygon-vertex attributes per vertex)
        n_el = g.child("LayerElementNormal")
        nrm = None
        if n_el is not None:
            narr = _coalesce_array(n_el.child("Normals"))
            mit = n_el.child("MappingInformationType")
            mapping = (mit.props[0] if mit and mit.props else "") or ""
            if narr is not None:
                narr = np.asarray(narr, np.float64).reshape(-1, 3)
                if "ByVert" in str(mapping) and narr.shape[0] == verts.shape[0]:
                    nrm = narr
                else:  # ByPolygonVertex: average onto shared vertices
                    flat_pv = [i for poly in polys for i in poly]
                    if narr.shape[0] == len(flat_pv):
                        acc = np.zeros_like(verts)
                        np.add.at(acc, flat_pv, narr)
                        ln = np.linalg.norm(acc, axis=-1, keepdims=True)
                        nrm = acc / np.maximum(ln, 1e-20)
                if nrm is not None:
                    # row-vector normals transform by the inverse (column
                    # form: inverse-transpose) — matters for non-uniform
                    # Lcl Scaling
                    nrm = nrm @ np.linalg.inv(xf[:3, :3])
                    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
                    nrm = nrm / np.maximum(ln, 1e-20)
        uv_el = g.child("LayerElementUV")
        uv = None
        if uv_el is not None:
            uarr = _coalesce_array(uv_el.child("UV"))
            uidx = _coalesce_array(uv_el.child("UVIndex"))
            if uarr is not None:
                uarr = np.asarray(uarr, np.float64).reshape(-1, 2)
                flat_pv = [i for poly in polys for i in poly]
                per_pv = (
                    uarr[np.asarray(uidx, np.int64)]
                    if uidx is not None and len(uidx) == len(flat_pv)
                    else (uarr if uarr.shape[0] == len(flat_pv) else None)
                )
                if per_pv is not None:
                    acc = np.zeros((verts.shape[0], 2))
                    cnt = np.zeros((verts.shape[0], 1))
                    np.add.at(acc, flat_pv, per_pv)
                    np.add.at(cnt, flat_pv, 1.0)
                    uv = acc / np.maximum(cnt, 1.0)
                elif uarr.shape[0] == verts.shape[0]:
                    uv = uarr

        all_v.append(verts)
        all_f.append(f + base)
        all_n.append(nrm)
        all_uv.append(uv)
        base += verts.shape[0]

    if not all_v:
        raise ValueError(f"{path}: no mesh geometry found")
    v = np.concatenate(all_v).astype(np.float32)
    f = np.concatenate(all_f).astype(np.uint32)
    if all(n is not None for n in all_n):
        n = np.concatenate(all_n).astype(np.float32)
    else:
        n = generate_normals(v, f)
    if all(u is not None for u in all_uv):
        uv = np.concatenate(all_uv).astype(np.float32)
    else:
        uv = np.zeros((v.shape[0], 2), np.float32)
    tan = generate_tangents(v, n, uv, f)
    return Mesh(vertices=v, normals=n, tangents=tan, texcoords=uv, indices=f)
