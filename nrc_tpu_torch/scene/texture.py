"""Host texture subsystem: image loading, mip pyramids, the flat texture atlas.

The port's copy of ``nrc_tpu/scene/texture.py`` (numpy only): the
reference's DevIL ``Picture`` loader and CUDA-array ``Texture`` objects
(``nrc/src/Picture.cpp``, ``nrc/src/Texture.cpp:44-693``, upload
``nrc/src/Device.cpp:3014-3283``) become ONE flat ``[total_texels, 4]``
float32 array of every mip level of every texture plus per-(texture, level)
descriptor rows, looked up by software bilinear fetches in the wavefront
(``ops/texture.py``). sRGB-tagged images are converted to linear float at
load (MDL's ``tex::gamma_srgb``); alpha stays linear. Rows are stored
bottom-up so that ``v = 0`` is the bottom scanline (the MDL texture
runtime's convention, ``shaders/texture_lookup.h``).

Images are read without an image library: PNG (8-bit RGB) through
``utils/image_io.read_png`` and Radiance ``.hdr`` through
``utils/hdr_loader.py``. DDS files are not ported yet (ROADMAP Queue 1
item 4, ``dds_loader``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from ..utils.hdr_loader import load_radiance_hdr
from ..utils.image_io import read_png


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def load_image_rgba(path: str) -> np.ndarray:
    """An image file -> float32 RGBA [H, W, 4], values as stored (no gamma
    conversion): PNG scaled by 1/255 with alpha 1, Radiance ``.hdr`` with
    alpha 1. The JAX package reads PNGs through PIL where it is installed,
    which gives the same floats for an 8-bit RGB file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        rgb = load_radiance_hdr(path).astype(np.float32)
    elif ext == ".dds":
        raise NotImplementedError(
            f"{path}: DDS images are not ported yet (ROADMAP Queue 1 item 4, dds_loader)"
        )
    else:
        rgb = read_png(path).astype(np.float32) / 255.0
    a = np.ones(rgb.shape[:2] + (1,), np.float32)
    return np.concatenate([rgb, a], axis=-1)


def build_mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Full mip pyramid by 2x2 box filter down to 1x1 (odd dims edge-pad),
    like the CUDA mipmap generation of the reference's ``Texture.cpp``."""
    chain = [img]
    cur = img
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape[:2]
        if h % 2:
            cur = np.concatenate([cur, cur[-1:]], axis=0)
            h += 1
        if w % 2:
            cur = np.concatenate([cur, cur[:, -1:]], axis=1)
            w += 1
        cur = (
            cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 1::2]
        ) * 0.25
        chain.append(cur)
    return chain


@dataclasses.dataclass
class TextureAtlas:
    """All scene 2D textures packed into flat arrays (host side).

    - ``texels``: [total, 4] f32, all mip levels of all textures concatenated.
    - per level-entry: ``level_offset/level_w/level_h`` (flat texel offset,
      width, height).
    - per texture: ``tex_level_base`` (first level-entry), ``tex_num_levels``.
    """

    texels: np.ndarray
    level_offset: np.ndarray
    level_w: np.ndarray
    level_h: np.ndarray
    tex_level_base: np.ndarray
    tex_num_levels: np.ndarray
    _ids: Dict[Tuple[str, bool], int]

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            texels=np.ones((1, 4), np.float32),  # texel 0 = white fallback
            level_offset=np.zeros((0,), np.int32),
            level_w=np.zeros((0,), np.int32),
            level_h=np.zeros((0,), np.int32),
            tex_level_base=np.zeros((0,), np.int32),
            tex_num_levels=np.zeros((0,), np.int32),
            _ids={},
        )

    @property
    def num_textures(self) -> int:
        return int(self.tex_level_base.shape[0])

    def add(self, path: str, srgb: bool = True) -> int:
        """Load + mip + append a texture; returns its id. Dedup by
        (abspath, gamma) like the reference's shared texture cache
        (``Device::shareTextureMDL``, ``Device.cpp:3285``)."""
        key = (os.path.abspath(path), srgb)
        if key in self._ids:
            return self._ids[key]
        img = load_image_rgba(path)
        img = img[::-1]  # bottom-up rows: v=0 = bottom (MDL convention)
        if srgb:
            img = np.concatenate(
                [_srgb_to_linear(img[..., :3]), img[..., 3:4]], axis=-1
            )
        chain = build_mip_chain(img.astype(np.float32))

        tex_id = self.num_textures
        base = int(self.level_w.shape[0])
        offset = int(self.texels.shape[0])
        offs, ws, hs, blocks = [], [], [], []
        for lvl in chain:
            h, w = lvl.shape[:2]
            offs.append(offset)
            ws.append(w)
            hs.append(h)
            blocks.append(lvl.reshape(-1, 4))
            offset += w * h
        self.texels = np.concatenate([self.texels] + blocks, axis=0)
        self.level_offset = np.concatenate(
            [self.level_offset, np.asarray(offs, np.int32)]
        )
        self.level_w = np.concatenate([self.level_w, np.asarray(ws, np.int32)])
        self.level_h = np.concatenate([self.level_h, np.asarray(hs, np.int32)])
        self.tex_level_base = np.concatenate(
            [self.tex_level_base, np.asarray([base], np.int32)]
        )
        self.tex_num_levels = np.concatenate(
            [self.tex_num_levels, np.asarray([len(chain)], np.int32)]
        )
        self._ids[key] = tex_id
        return tex_id

    def device_arrays(self) -> dict:
        """The host (numpy) arrays ``ops.texture`` looks up, by name; with no
        textures, 1-entry dummies keep every shape valid."""

        def pad1(a, fill):
            return a if a.shape[0] else np.asarray([fill], a.dtype)

        return {
            "texels": np.ascontiguousarray(self.texels, np.float32),
            "level_offset": pad1(self.level_offset, 0),
            "level_w": pad1(self.level_w, 1),
            "level_h": pad1(self.level_h, 1),
            "tex_level_base": pad1(self.tex_level_base, 0),
            "tex_num_levels": pad1(self.tex_num_levels, 1),
            # each row holds the texel's own wrap-neighbour 2x2 window
            # [T(y,x)|T(y,x+1)|T(y+1,x)|T(y+1,x+1)]: a bilinear fetch is ONE
            # row gather of 16 floats instead of four
            "texels_quad": self._quad_texels(),
        }

    def _quad_texels(self) -> np.ndarray:
        t = self.texels
        quad = np.empty((t.shape[0], 16), np.float32)
        quad[:, 0:4] = t
        quad[:, 4:16] = np.tile(t, 3)  # texel 0 (white) + any unowned rows
        for off, w, h in zip(
            self.level_offset, self.level_w, self.level_h
        ):
            off, w, h = int(off), int(w), int(h)
            lv = t[off: off + w * h].reshape(h, w, 4)
            xp = np.roll(lv, -1, axis=1)
            yp = np.roll(lv, -1, axis=0)
            xyp = np.roll(xp, -1, axis=0)
            sl = slice(off, off + w * h)
            quad[sl, 4:8] = xp.reshape(-1, 4)
            quad[sl, 8:12] = yp.reshape(-1, 4)
            quad[sl, 12:16] = xyp.reshape(-1, 4)
        return quad
