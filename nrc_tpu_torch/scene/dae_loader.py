"""COLLADA (.dae) mesh importer -> Mesh.

The port's copy of ``nrc_tpu/scene/dae_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Another format of the mesh-import path standing in for the reference's
Assimp importer (``Application::createASSIMP``, ``nrc/src/Assimp.cpp:54-239``).
Scope: static geometry — ``library_geometries`` meshes (``triangles`` and
``polylist`` primitives, fan-triangulated), POSITION/NORMAL/TEXCOORD inputs
with per-corner index streams, and ``library_visual_scenes`` node transforms
(``matrix`` / ``translate`` / ``rotate`` / ``scale``, nested nodes) applied
through ``instance_geometry``. No skinning, animation, or materials.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents


def _strip(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _floats(text: Optional[str]) -> np.ndarray:
    return np.asarray([float(x) for x in (text or "").split()], np.float64)


def _ints(text: Optional[str]) -> np.ndarray:
    return np.asarray([int(x) for x in (text or "").split()], np.int64)


def _find(el, name):
    for c in el:
        if _strip(c.tag) == name:
            return c
    return None


def _findall(el, name):
    return [c for c in el if _strip(c.tag) == name]


def _node_transform(node) -> np.ndarray:
    """Compose a node's transform elements in document order."""
    m = np.eye(4)
    for c in node:
        tag = _strip(c.tag)
        if tag == "matrix":
            m = m @ _floats(c.text).reshape(4, 4)
        elif tag == "translate":
            t = np.eye(4)
            t[:3, 3] = _floats(c.text)[:3]
            m = m @ t
        elif tag == "scale":
            s = np.eye(4)
            np.fill_diagonal(s[:3, :3], _floats(c.text)[:3])
            m = m @ s
        elif tag == "rotate":
            x, y, z, deg = _floats(c.text)[:4]
            axis = np.asarray([x, y, z])
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                a = np.deg2rad(deg)
                c_, s_ = np.cos(a), np.sin(a)
                K = np.array([
                    [0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0],
                ])
                r = np.eye(4)
                r[:3, :3] = np.eye(3) * c_ + s_ * K + (1 - c_) * np.outer(axis, axis)
                m = m @ r
    return m


def _mesh_sources(mesh_el) -> Dict[str, np.ndarray]:
    """source id -> [N, stride] float array."""
    out = {}
    for src in _findall(mesh_el, "source"):
        arr_el = _find(src, "float_array")
        if arr_el is None:
            continue
        data = _floats(arr_el.text)
        stride = 3
        tech = _find(src, "technique_common")
        if tech is not None:
            acc = _find(tech, "accessor")
            if acc is not None:
                stride = int(acc.get("stride", "3"))
        out["#" + (src.get("id") or "")] = data.reshape(-1, stride)
    # vertices indirection: <vertices id=X><input semantic=POSITION source=#Y>
    verts_el = _find(mesh_el, "vertices")
    if verts_el is not None:
        for inp in _findall(verts_el, "input"):
            if inp.get("semantic") == "POSITION":
                src = inp.get("source")
                if src in out:
                    out["#" + (verts_el.get("id") or "")] = out[src]
    return out


def _extract_geometry(geom_el):
    """-> (positions [V,3], faces [F,3] into V, per-corner normals, uvs)."""
    mesh_el = _find(geom_el, "mesh")
    if mesh_el is None:
        return None
    sources = _mesh_sources(mesh_el)
    v_all, f_all = None, []
    # per-vertex attribute accumulators shared ACROSS primitives (a mesh
    # with several <triangles>/<polylist> blocks — one per material — must
    # merge contributions, not keep only the last block's)
    n_sum = n_cnt = uv_sum = uv_cnt = None

    for prim in list(_findall(mesh_el, "triangles")) + list(
        _findall(mesh_el, "polylist")
    ):
        inputs = []  # (semantic, offset, source_arr)
        max_off = 0
        for inp in _findall(prim, "input"):
            sem = inp.get("semantic")
            off = int(inp.get("offset", "0"))
            src = sources.get(inp.get("source") or "")
            inputs.append((sem, off, src))
            max_off = max(max_off, off)
        stride = max_off + 1
        p = _ints(_find(prim, "p").text if _find(prim, "p") is not None else "")
        if p.size == 0:
            continue
        corners = p.reshape(-1, stride)

        if _strip(prim.tag) == "polylist":
            vcount = _ints(
                _find(prim, "vcount").text
                if _find(prim, "vcount") is not None else ""
            )
        else:
            vcount = np.full(corners.shape[0] // 3, 3, np.int64)

        # fan-triangulate into corner-row indices
        tri_rows = []
        base = 0
        for vc in vcount:
            for k in range(1, int(vc) - 1):
                tri_rows.append((base, base + k, base + k + 1))
            base += int(vc)
        tri_rows = np.asarray(tri_rows, np.int64)

        pos_src = next(
            (s for sem, off, s in inputs if sem in ("VERTEX", "POSITION")),
            None,
        )
        pos_off = next(
            (off for sem, off, s in inputs if sem in ("VERTEX", "POSITION")), 0
        )
        if pos_src is None:
            continue
        if v_all is None:
            v_all = pos_src[:, :3]
        v_idx = corners[:, pos_off]
        f_all.append(v_idx[tri_rows])

        # per-corner attributes accumulated onto shared vertices
        for sem, off, src in inputs:
            if src is None or sem not in ("NORMAL", "TEXCOORD"):
                continue
            per_corner = src[corners[:, off]]
            dims = 3 if sem == "NORMAL" else 2
            if sem == "NORMAL" and n_sum is None:
                n_sum = np.zeros((v_all.shape[0], 3))
                n_cnt = np.zeros((v_all.shape[0], 1))
            if sem == "TEXCOORD" and uv_sum is None:
                uv_sum = np.zeros((v_all.shape[0], 2))
                uv_cnt = np.zeros((v_all.shape[0], 1))
            acc, cnt = (n_sum, n_cnt) if sem == "NORMAL" else (uv_sum, uv_cnt)
            np.add.at(acc, v_idx, per_corner[:, :dims])
            np.add.at(cnt, v_idx, 1.0)

    if v_all is None or not f_all:
        return None
    n_acc = n_sum / np.maximum(n_cnt, 1.0) if n_sum is not None else None
    uv_acc = uv_sum / np.maximum(uv_cnt, 1.0) if uv_sum is not None else None
    return v_all, np.concatenate(f_all), n_acc, uv_acc


def load_dae(path: str) -> Mesh:
    root = ET.parse(path).getroot()
    lib_geo = None
    lib_scenes = None
    for c in root:
        if _strip(c.tag) == "library_geometries":
            lib_geo = c
        elif _strip(c.tag) == "library_visual_scenes":
            lib_scenes = c
    if lib_geo is None:
        raise ValueError(f"{path}: no library_geometries")

    geoms = {}
    for g in _findall(lib_geo, "geometry"):
        got = _extract_geometry(g)
        if got is not None:
            geoms["#" + (g.get("id") or "")] = got

    # instance transforms from the visual scene (nested nodes compose)
    instances: List[tuple] = []

    def walk(node, xf):
        xf = xf @ _node_transform(node)
        for c in node:
            tag = _strip(c.tag)
            if tag == "instance_geometry":
                url = c.get("url") or ""
                if url in geoms:
                    instances.append((url, xf))
            elif tag == "node":
                walk(c, xf)

    if lib_scenes is not None:
        for vs in _findall(lib_scenes, "visual_scene"):
            for node in _findall(vs, "node"):
                walk(node, np.eye(4))
    if not instances:  # no scene: import all geometries untransformed
        instances = [(k, np.eye(4)) for k in geoms]
    if not instances:
        raise ValueError(f"{path}: no mesh geometry found")

    all_v, all_f, all_n, all_uv = [], [], [], []
    base = 0
    for url, xf in instances:
        v, f, nrm, uv = geoms[url]
        vw = v @ xf[:3, :3].T + xf[:3, 3]
        all_v.append(vw)
        all_f.append(f + base)
        if nrm is not None:
            # row-vector normals transform by the inverse (column form:
            # inverse-transpose): n' = n @ M^-1
            nw = nrm @ np.linalg.inv(xf[:3, :3])
            ln = np.linalg.norm(nw, axis=-1, keepdims=True)
            all_n.append(nw / np.maximum(ln, 1e-20))
        else:
            all_n.append(None)
        all_uv.append(uv)
        base += vw.shape[0]

    v = np.concatenate(all_v).astype(np.float32)
    f = np.concatenate(all_f).astype(np.uint32)
    n = (
        np.concatenate(all_n).astype(np.float32)
        if all(x is not None for x in all_n)
        else generate_normals(v, f)
    )
    uv = (
        np.concatenate(all_uv).astype(np.float32)
        if all(x is not None for x in all_uv)
        else np.zeros((v.shape[0], 2), np.float32)
    )
    tan = generate_tangents(v, n, uv, f)
    return Mesh(vertices=v, normals=n, tangents=tan, texcoords=uv, indices=f)
