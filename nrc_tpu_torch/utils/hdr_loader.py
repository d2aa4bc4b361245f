"""Radiance ``.hdr`` (RGBE) loader, flat and adaptive-RLE scanlines (numpy).

The port's copy of ``nrc_tpu/utils/hdr_loader.py`` without its native
decoder: the reference loads environment maps through DevIL
(``nrc/src/Picture.cpp``). The decode is the same byte for byte, so both
packages read the same floats from a file.
"""

from __future__ import annotations

import numpy as np


def load_radiance_hdr(path: str) -> np.ndarray:
    """A Radiance HDR file -> [H, W, 3] float32 linear RGB.

    Row 0 of the output is the bottom row (v = 0, the south pole), the
    reference's lower-left texture origin: a ``-Y`` file (first scanline at
    the top) is flipped, a ``+Y`` file is not.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")

    pos = 0
    while True:  # header lines up to a blank one
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    dims = data[pos:eol].split()  # e.g. "-Y 1500 +X 3000"
    pos = eol + 1
    if dims[0] not in (b"-Y", b"+Y"):
        raise ValueError(f"unsupported resolution line {dims}")
    h, w = int(dims[1]), int(dims[3])
    flip_y = dims[0] == b"-Y"

    buf = np.frombuffer(data, np.uint8)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    for y in range(h):
        if pos + 4 > len(data):
            raise ValueError("truncated HDR")
        if data[pos] == 2 and data[pos + 1] == 2 and ((data[pos + 2] << 8) | data[pos + 3]) == w:
            # adaptive RLE scanline: the four component planes one after another
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise ValueError("corrupt HDR scanline data")
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:  # a run of one value
                        cnt -= 128
                        if pos >= len(data) or x + cnt > w:
                            raise ValueError("corrupt HDR scanline data")
                        rgbe[y, x : x + cnt, c] = data[pos]
                        pos += 1
                    else:  # literal bytes
                        if pos + cnt > len(data) or x + cnt > w:
                            raise ValueError("corrupt HDR scanline data")
                        rgbe[y, x : x + cnt, c] = buf[pos : pos + cnt]
                        pos += cnt
                    x += cnt
        else:  # flat RGBE scanline
            if pos + 4 * w > len(data):
                raise ValueError("corrupt HDR scanline data")
            rgbe[y] = buf[pos : pos + 4 * w].reshape(w, 4)
            pos += 4 * w
    return _rgbe_to_float(rgbe, flip_y)


def _rgbe_to_float(rgbe: np.ndarray, flip_y: bool) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32) - 128
    scale = np.ldexp(1.0, e - 8).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    if flip_y:
        out = out[::-1]
    return np.ascontiguousarray(out)
