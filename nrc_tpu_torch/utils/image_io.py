"""Image files: PNG (tonemapped LDR) and Radiance .hdr (linear HDR).

A copy of ``nrc_tpu/utils/image_io.py`` (numpy, ``zlib`` and ``struct``; no
image library), so that the port never imports the JAX package: the
reference's DevIL screenshot path (``Application.cpp:2562-2673``, Key P ->
tonemapped PNG, Key H -> linear ``.hdr``), with minimal readers of the
files it writes. A PNG written from the same pixels is the same bytes as
the JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an RGB8 PNG. ``rgb_u8``: [H, W, 3] uint8."""
    img = np.asarray(rgb_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own RGB8 non-interlaced files (test roundtrip)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert depth == 8 and ctype == 2, "only RGB8 supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], dtype=np.uint8
        ).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        else:
            # Sub/Average/Paeth need sequential reconstruction
            cur = np.zeros(stride, dtype=np.int32)
            for x in range(stride):
                a = cur[x - 3] if x >= 3 else 0
                b = prev[x]
                c = prev[x - 3] if x >= 3 else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad filter {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.reshape(w, 3).astype(np.uint8)
        prev = cur
    return out


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a linear Radiance RGBE ``.hdr`` image. ``rgb``: [H, W, 3] float."""
    img = np.asarray(rgb, dtype=np.float32)
    h, w, _ = img.shape
    maxc = np.max(img, axis=-1)
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.maximum(maxc, 1e-32))
    scale = m * 256.0 / np.maximum(maxc, 1e-32)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.clip(e + 128, 0, 255).astype(np.uint8)
    rgbe[maxc < 1e-32] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())  # flat (non-RLE) scanlines


def read_hdr(path: str) -> np.ndarray:
    """Minimal reader for our own flat-RGBE ``.hdr`` files (test roundtrip)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", header_end)
    dims = data[header_end:dim_end].split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data[dim_end + 1 :], dtype=np.uint8).reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int32) - 128
    scale = np.ldexp(1.0, e - 8).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out
