"""DDS (DirectDraw Surface) image loader: header parse + block decompression.

The port's copy of ``nrc_tpu/scene/dds_loader.py`` (numpy only): the same
decode, so a file gives the same arrays bit for bit.

Fills the DevIL DDS capability of the reference's ``Picture`` loader
(``nrc/src/Picture.cpp`` loads LDR/HDR/DDS/cube images through DevIL;
``nrc/src/Texture.cpp`` consumes them). Pure NumPy, vectorized over blocks.

Supported:
- BC1/DXT1 (565 palette, 1-bit punch-through alpha), BC2/DXT3 (explicit
  4-bit alpha), BC3/DXT5 (interpolated alpha), BC4 (single channel),
  BC5 (two channel) — both legacy FourCC and DX10 DXGI formats.
- Uncompressed mask formats (RGB/RGBA bitmasks incl. BGRA8, RGBA8, BGR8,
  R5G6B5, luminance, alpha-only).
- Float formats: R16G16B16A16F / R32G32B32A32F / R32F (FourCC 111-116 and
  the DXGI equivalents).
- Cube maps (DDSCAPS2_CUBEMAP): all six faces decoded; ``load_dds`` returns
  them stacked ``[6, H, W, 4]`` in the +X -X +Y -Y +Z -Z order.
- Mip chains are parsed to locate face offsets; only the top level of each
  face is returned (the atlas builds its own mip pyramid,
  ``scene/texture.py::build_mip_chain``).

Values are returned as float32 RGBA in [0, 1] for UNORM sources and raw
float for float sources, matching ``load_image_rgba``'s contract.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

DDSD_MIPMAPCOUNT = 0x20000
DDPF_ALPHAPIXELS = 0x1
DDPF_ALPHA = 0x2
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40
DDPF_LUMINANCE = 0x20000
DDSCAPS2_CUBEMAP = 0x200

# DXGI formats (DX10 header) we understand
_DXGI_BC = {
    71: "BC1", 72: "BC1",          # BC1_UNORM(_SRGB)
    74: "BC2", 75: "BC2",
    77: "BC3", 78: "BC3",
    80: "BC4", 81: "BC4S",         # BC4_UNORM / BC4_SNORM
    83: "BC5", 84: "BC5S",         # BC5_UNORM / BC5_SNORM
}
_DXGI_UNCOMP = {
    28: ("rgba8", False), 29: ("rgba8", True),   # R8G8B8A8_UNORM(_SRGB)
    87: ("bgra8", False), 91: ("bgra8", True),   # B8G8R8A8_UNORM(_SRGB)
    2: ("rgba32f", False),                        # R32G32B32A32_FLOAT
    10: ("rgba16f", False),                       # R16G16B16A16_FLOAT
    41: ("r32f", False),                          # R32_FLOAT
}


def _expand_bits(v: np.ndarray, bits: int) -> np.ndarray:
    """UNORM n-bit -> float in [0,1]."""
    if bits == 0:
        return np.ones_like(v, np.float32)
    return v.astype(np.float32) / float((1 << bits) - 1)


def _decode_565(c: np.ndarray) -> np.ndarray:
    """[N] u16 -> [N, 3] float RGB."""
    r = _expand_bits((c >> 11) & 0x1F, 5)
    g = _expand_bits((c >> 5) & 0x3F, 6)
    b = _expand_bits(c & 0x1F, 5)
    return np.stack([r, g, b], axis=-1)


def _color_indices(rows: np.ndarray) -> np.ndarray:
    """[N, 4] u8 row bytes (2-bit indices) -> [N, 16] int indices."""
    idx = rows[:, :, None] >> (np.arange(4, dtype=np.uint8) * 2)[None, None, :]
    return (idx & 0x3).reshape(rows.shape[0], 16)


def _decode_bc1_color(blocks: np.ndarray, force_opaque: bool) -> Tuple[np.ndarray, np.ndarray]:
    """BC1 color part: blocks [N, 8] u8 -> (rgb [N, 16, 3], alpha [N, 16]).

    ``force_opaque``: BC2/BC3 always use the 4-color mode regardless of the
    c0<=c1 comparison (per the spec)."""
    n = blocks.shape[0]
    c01 = blocks[:, :4].reshape(n, 2, 2)
    c0 = (c01[:, 0, 0].astype(np.uint16) | (c01[:, 0, 1].astype(np.uint16) << 8))
    c1 = (c01[:, 1, 0].astype(np.uint16) | (c01[:, 1, 1].astype(np.uint16) << 8))
    rgb0 = _decode_565(c0)
    rgb1 = _decode_565(c1)
    four = (c0 > c1) | force_opaque
    f = four[:, None].astype(np.float32)
    # palette entries 2/3 in both modes
    p2 = np.where(
        four[:, None], (2.0 * rgb0 + rgb1) / 3.0, (rgb0 + rgb1) * 0.5
    )
    p3 = np.where(four[:, None], (rgb0 + 2.0 * rgb1) / 3.0, 0.0)
    pal = np.stack([rgb0, rgb1, p2, p3], axis=1)          # [N, 4, 3]
    idx = _color_indices(blocks[:, 4:8])                  # [N, 16]
    rgb = np.take_along_axis(pal, idx[:, :, None], axis=1)
    alpha = np.where(
        (~four[:, None]) & (idx == 3), np.float32(0.0), np.float32(1.0)
    )
    _ = f
    return rgb.astype(np.float32), alpha.astype(np.float32)


def _decode_bc3_alpha(blocks: np.ndarray) -> np.ndarray:
    """BC3/BC4 interpolated-alpha part: [N, 8] u8 -> [N, 16] float."""
    n = blocks.shape[0]
    a0 = blocks[:, 0].astype(np.float32)
    a1 = blocks[:, 1].astype(np.float32)
    # 48-bit little-endian index stream, 3 bits per texel
    bits = np.zeros(n, np.uint64)
    for i in range(6):
        bits |= blocks[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    sel = (
        (bits[:, None] >> (np.arange(16, dtype=np.uint64) * np.uint64(3)))
        & np.uint64(0x7)
    ).astype(np.int32)                                    # [N, 16]
    eight = a0 > a1
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    ks = np.arange(1, 7, dtype=np.float32)
    pal8 = (a0[:, None] * (7.0 - ks) + a1[:, None] * ks) / 7.0   # idx 2..7
    pal6 = np.zeros((n, 6), np.float32)
    ks5 = np.arange(1, 5, dtype=np.float32)
    pal6[:, :4] = (a0[:, None] * (5.0 - ks5) + a1[:, None] * ks5) / 5.0
    pal6[:, 4] = 0.0
    pal6[:, 5] = 255.0
    pal[:, 2:] = np.where(eight[:, None], pal8, pal6)
    return np.take_along_axis(pal, sel, axis=1) / 255.0


def _decode_bc45_snorm(blocks: np.ndarray) -> np.ndarray:
    """BC4/BC5 SNORM channel block: int8 endpoints, values in [-1, 1]
    (six-value mode's fixed entries are -1 and +1)."""
    n = blocks.shape[0]
    a0 = np.maximum(blocks[:, 0].view(np.int8).astype(np.float32), -127.0)
    a1 = np.maximum(blocks[:, 1].view(np.int8).astype(np.float32), -127.0)
    bits = np.zeros(n, np.uint64)
    for i in range(6):
        bits |= blocks[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    sel = (
        (bits[:, None] >> (np.arange(16, dtype=np.uint64) * np.uint64(3)))
        & np.uint64(0x7)
    ).astype(np.int32)
    eight = a0 > a1
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    ks = np.arange(1, 7, dtype=np.float32)
    pal8 = (a0[:, None] * (7.0 - ks) + a1[:, None] * ks) / 7.0
    pal6 = np.zeros((n, 6), np.float32)
    ks5 = np.arange(1, 5, dtype=np.float32)
    pal6[:, :4] = (a0[:, None] * (5.0 - ks5) + a1[:, None] * ks5) / 5.0
    pal6[:, 4] = -127.0
    pal6[:, 5] = 127.0
    pal[:, 2:] = np.where(eight[:, None], pal8, pal6)
    return np.clip(np.take_along_axis(pal, sel, axis=1) / 127.0, -1.0, 1.0)


def _decode_bc2_alpha(blocks: np.ndarray) -> np.ndarray:
    """BC2 explicit 4-bit alpha: [N, 8] u8 -> [N, 16] float."""
    lo = (blocks & 0xF).astype(np.float32) / 15.0
    hi = ((blocks >> 4) & 0xF).astype(np.float32) / 15.0
    return np.stack([lo, hi], axis=-1).reshape(blocks.shape[0], 16)


def _blocks_to_image(tex: np.ndarray, w: int, h: int) -> np.ndarray:
    """[N_blocks, 16, C] texel blocks (4x4 row-major) -> [h, w, C]."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    c = tex.shape[-1]
    img = tex.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, c)
    return img[:h, :w]


def _decode_bc(data: np.ndarray, w: int, h: int, kind: str) -> np.ndarray:
    bw, bh = (w + 3) // 4, (h + 3) // 4
    nb = bw * bh
    bs = 8 if kind in ("BC1", "BC4", "BC4S") else 16
    blocks = data[: nb * bs].reshape(nb, bs)
    if kind == "BC1":
        rgb, a = _decode_bc1_color(blocks, force_opaque=False)
        tex = np.concatenate([rgb, a[:, :, None]], axis=-1)
    elif kind == "BC2":
        a = _decode_bc2_alpha(blocks[:, :8])
        rgb, _ = _decode_bc1_color(blocks[:, 8:], force_opaque=True)
        tex = np.concatenate([rgb, a[:, :, None]], axis=-1)
    elif kind == "BC3":
        a = _decode_bc3_alpha(blocks[:, :8])
        rgb, _ = _decode_bc1_color(blocks[:, 8:], force_opaque=True)
        tex = np.concatenate([rgb, a[:, :, None]], axis=-1)
    elif kind in ("BC4", "BC4S"):
        dec = _decode_bc3_alpha if kind == "BC4" else _decode_bc45_snorm
        r = dec(blocks)
        z = np.zeros_like(r)
        tex = np.stack([r, z, z, np.ones_like(r)], axis=-1)
    elif kind in ("BC5", "BC5S"):
        dec = _decode_bc3_alpha if kind == "BC5" else _decode_bc45_snorm
        r = dec(blocks[:, :8])
        g = dec(blocks[:, 8:])
        z = np.zeros_like(r)
        tex = np.stack([r, g, z, np.ones_like(r)], axis=-1)
    else:  # pragma: no cover
        raise ValueError(f"unsupported BC kind {kind}")
    return _blocks_to_image(tex, w, h)


def _mask_shift_bits(mask: int) -> Tuple[int, int]:
    if mask == 0:
        return 0, 0
    shift = (mask & -mask).bit_length() - 1
    bits = (mask >> shift).bit_length()
    return shift, bits


def _decode_masked(
    data: np.ndarray, w: int, h: int, bpp: int, masks: Tuple[int, int, int, int]
) -> np.ndarray:
    """Generic uncompressed path: per-channel bitmask extraction."""
    nbytes = bpp // 8
    px = data[: w * h * nbytes].reshape(h * w, nbytes).astype(np.uint32)
    v = np.zeros(h * w, np.uint32)
    for i in range(nbytes):
        v |= px[:, i] << np.uint32(8 * i)
    out = np.empty((h * w, 4), np.float32)
    for ch, mask in enumerate(masks):
        if mask == 0:
            out[:, ch] = 1.0 if ch == 3 else 0.0
        else:
            shift, bits = _mask_shift_bits(mask)
            out[:, ch] = _expand_bits((v >> np.uint32(shift)) & np.uint32(mask >> shift), bits)
    return out.reshape(h, w, 4)


def _bc_size(w: int, h: int, kind: str) -> int:
    bs = 8 if kind in ("BC1", "BC4", "BC4S") else 16
    return ((w + 3) // 4) * ((h + 3) // 4) * bs


def _float_decode(data: np.ndarray, w: int, h: int, fmt: str) -> np.ndarray:
    if fmt == "rgba32f":
        a = data[: w * h * 16].view(np.float32).reshape(h, w, 4)
        return a.astype(np.float32)
    if fmt == "rgba16f":
        a = data[: w * h * 8].view(np.float16).reshape(h, w, 4)
        return a.astype(np.float32)
    if fmt == "r32f":
        r = data[: w * h * 4].view(np.float32).reshape(h, w)
        out = np.zeros((h, w, 4), np.float32)
        out[..., 0] = r
        out[..., 3] = 1.0
        return out
    raise ValueError(fmt)


def _float_size(w: int, h: int, fmt: str) -> int:
    return w * h * {"rgba32f": 16, "rgba16f": 8, "r32f": 4}[fmt]


# legacy D3DFMT float FourCC codes
_D3DFMT_FLOAT = {114: "r32f", 113: "rgba16f", 116: "rgba32f"}


def load_dds(path: str) -> np.ndarray:
    """Load a .dds file -> float32 RGBA ``[H, W, 4]``, or ``[6, H, W, 4]``
    for cube maps (+X -X +Y -Y +Z -Z face order)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"DDS ":
        raise ValueError(f"{path}: not a DDS file")
    (size, flags, h, w, _pitch, _depth, mipmaps) = struct.unpack_from("<7I", raw, 4)
    if size != 124:
        raise ValueError(f"{path}: bad DDS header size {size}")
    mipmaps = max(1, mipmaps if (flags & DDSD_MIPMAPCOUNT) else 1)
    (pf_size, pf_flags, fourcc, bpp, rmask, gmask, bmask, amask) = struct.unpack_from(
        "<2I4s5I", raw, 4 + 72
    )
    caps2 = struct.unpack_from("<I", raw, 4 + 108)[0]  # header offset 108
    is_cube = bool(caps2 & DDSCAPS2_CUBEMAP)
    off = 4 + 124

    kind = None        # BC kind
    uncomp = None      # ("rgba8"/"bgra8"/float fmt)
    if pf_flags & DDPF_FOURCC:
        cc = fourcc.decode("ascii", "replace")
        if cc == "DX10":
            dxgi, _dim, misc, _asize, _misc2 = struct.unpack_from("<5I", raw, off)
            off += 20
            is_cube = is_cube or bool(misc & 0x4)
            if dxgi in _DXGI_BC:
                kind = _DXGI_BC[dxgi]
            elif dxgi in _DXGI_UNCOMP:
                uncomp = _DXGI_UNCOMP[dxgi][0]
            else:
                raise ValueError(f"{path}: unsupported DXGI format {dxgi}")
        elif cc in ("DXT1",):
            kind = "BC1"
        elif cc in ("DXT2", "DXT3"):
            kind = "BC2"
        elif cc in ("DXT4", "DXT5"):
            kind = "BC3"
        elif cc in ("ATI1", "BC4U"):
            kind = "BC4"
        elif cc in ("ATI2", "BC5U"):
            kind = "BC5"
        else:
            code = struct.unpack("<I", fourcc)[0]
            if code in _D3DFMT_FLOAT:
                uncomp = _D3DFMT_FLOAT[code]
            else:
                raise ValueError(f"{path}: unsupported FourCC {fourcc!r}")
    elif pf_flags & (DDPF_RGB | DDPF_LUMINANCE | DDPF_ALPHA):
        if pf_flags & DDPF_LUMINANCE:
            masks = (rmask, rmask, rmask, amask if pf_flags & DDPF_ALPHAPIXELS else 0)
        elif pf_flags & DDPF_RGB:
            masks = (rmask, gmask, bmask, amask if pf_flags & DDPF_ALPHAPIXELS else 0)
        else:
            masks = (0, 0, 0, amask)
        uncomp = ("masked", bpp, masks)
    else:
        raise ValueError(f"{path}: unsupported pixel format flags {pf_flags:#x}")

    data = np.frombuffer(raw, np.uint8, offset=off)

    def level_size(lw: int, lh: int) -> int:
        if kind is not None:
            return _bc_size(lw, lh, kind)
        if isinstance(uncomp, tuple):
            return lw * lh * (uncomp[1] // 8)
        if uncomp in ("rgba8", "bgra8"):
            return lw * lh * 4
        return _float_size(lw, lh, uncomp)

    def decode_top(buf: np.ndarray) -> np.ndarray:
        if kind is not None:
            return _decode_bc(buf, w, h, kind)
        if isinstance(uncomp, tuple):
            return _decode_masked(buf, w, h, uncomp[1], uncomp[2])
        if uncomp == "rgba8":
            return _decode_masked(buf, w, h, 32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000))
        if uncomp == "bgra8":
            return _decode_masked(buf, w, h, 32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000))
        return _float_decode(buf, w, h, uncomp)

    # face data size = full mip chain of one face
    face_bytes = 0
    lw, lh = w, h
    for _ in range(mipmaps):
        face_bytes += level_size(lw, lh)
        lw, lh = max(1, lw // 2), max(1, lh // 2)

    faces = 6 if is_cube else 1
    out = []
    for face in range(faces):
        start = face * face_bytes
        out.append(decode_top(data[start:]))
    return np.stack(out) if is_cube else out[0]
