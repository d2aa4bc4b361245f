"""glTF 2.0 mesh import (.gltf + .bin / .glb) -> Mesh.

The port's copy of ``nrc_tpu/scene/gltf_loader.py`` (numpy only): the same
parse, so a file gives the same ``Mesh`` arrays bit for bit.

Extends the Assimp-stand-in import path (``Application::createASSIMP``,
``nrc/src/Assimp.cpp:54-239``) to the glTF 2.0 format: JSON + external or
embedded (data-URI / GLB chunk) buffers, accessor/bufferView decoding with
byte strides, node-hierarchy transforms (matrix or TRS), triangle
primitives (mode 4, indexed or not). Geometry only — materials come from
the scene description's `.mdl` bindings, matching how the reference
assigns one declared material per imported model.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .geometry import Mesh, generate_normals, generate_tangents

_COMPONENT = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(doc: dict, buffers, idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT[acc["componentType"]]
    ncomp = _NCOMP[acc["type"]]
    count = acc["count"]
    item = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", item)
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = buffers[view["buffer"]]
    if stride == item:
        arr = np.frombuffer(raw, dtype, count * ncomp, offset)
        return arr.reshape(count, ncomp)
    rows = np.frombuffer(raw, np.uint8, count * stride, offset)
    rows = rows.reshape(count, stride)[:, : item]
    return rows.copy().view(dtype).reshape(count, ncomp)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0]).astype(np.float32)
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :3] = r
        m = m4 @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load_gltf(path: str) -> Mesh:
    base_dir = os.path.dirname(path)
    glb_bin = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            magic, version, _ = struct.unpack("<3I", f.read(12))
            assert magic == 0x46546C67, f"{path}: bad GLB magic"
            doc = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<2I", hdr)
                data = f.read(clen)
                if ctype == 0x4E4F534A:  # JSON
                    doc = json.loads(data)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = data
        assert doc is not None, f"{path}: no JSON chunk"
    else:
        with open(path) as f:
            doc = json.load(f)
    buffers = _load_buffers(doc, base_dir, glb_bin)

    # flatten the node hierarchy of the default scene (all meshes if none)
    mesh_instances = []  # (mesh index, 4x4 world matrix)
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [])
    if scenes:
        stack = [(n, np.eye(4, dtype=np.float32))
                 for n in scenes[scene_idx].get("nodes", [])]
        nodes = doc.get("nodes", [])
        while stack:
            ni, parent = stack.pop()
            node = nodes[ni]
            world = parent @ _node_matrix(node)
            if "mesh" in node:
                mesh_instances.append((node["mesh"], world))
            for c in node.get("children", []):
                stack.append((c, world))
    else:
        mesh_instances = [
            (i, np.eye(4, dtype=np.float32))
            for i in range(len(doc.get("meshes", [])))
        ]

    all_v, all_n, all_uv, all_f = [], [], [], []
    vbase = 0
    for mi, world in mesh_instances:
        nrm_mat = np.linalg.inv(world[:3, :3]).T
        for prim in doc["meshes"][mi].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            v = pos @ world[:3, :3].T + world[:3, 3]
            if "indices" in prim:
                idx = _accessor(doc, buffers, prim["indices"])
                idx = idx.reshape(-1).astype(np.uint32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.uint32)
            f = idx.reshape(-1, 3)
            if "NORMAL" in attrs:
                n = _accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                n = n @ nrm_mat.T
                ln = np.linalg.norm(n, axis=-1, keepdims=True)
                n = n / np.maximum(ln, 1e-20)
            else:
                n = generate_normals(v, f)
            if "TEXCOORD_0" in attrs:
                uv = _accessor(doc, buffers, attrs["TEXCOORD_0"])
                if uv.dtype != np.float32:  # normalized integer uvs
                    uv = uv.astype(np.float32) / np.iinfo(uv.dtype).max
            else:
                uv = np.zeros((v.shape[0], 2), np.float32)
            all_v.append(v)
            all_n.append(n.astype(np.float32))
            all_uv.append(uv.astype(np.float32))
            all_f.append(f + vbase)
            vbase += v.shape[0]

    if not all_v:
        raise ValueError(f"{path}: no triangle primitives")
    v = np.concatenate(all_v)
    n = np.concatenate(all_n)
    uv = np.concatenate(all_uv)
    f = np.concatenate(all_f)
    return Mesh(
        vertices=v, normals=n, tangents=generate_tangents(v, n, uv, f),
        texcoords=uv, indices=f,
    )
