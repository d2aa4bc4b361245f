"""IESNA LM-63 photometric file loader and its goniometric candela texture.

The port's copy of ``nrc_tpu/scene/ies.py`` (numpy only): the reference's
``LoaderIES`` (LM-63-86/91/95/02 parser, ``nrc/inc/LoaderIES.h:38-160``,
``nrc/src/LoaderIES.cpp``) and ``Picture::createIES`` (symmetry expansion +
omnidirectional projection texture, ``nrc/src/Picture.cpp:1330-1454``).
The result is a single-channel candela texture over the full sphere,
sampled in ``ops/light_sampling.py`` with the same (u, v) convention as
``light_sample.cu:186-199``:

    u = (atan2(-R.x, R.z) + pi) / 2pi     (azimuth, wraps)
    v = acos(-R.y) / pi                   (v=0 at vertical angle 0 == nadir)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IESData:
    """Parsed LM-63 photometry (subset used for rendering)."""

    vertical_angles: np.ndarray    # [V] degrees, ascending
    horizontal_angles: np.ndarray  # [H] degrees, ascending
    candela: np.ndarray            # [H, V] f32
    multiplier: float              # candela multiplier * ballast factors
    photometric_type: int          # 1=C, 2=B, 3=A
    lumens_per_lamp: float
    num_lamps: int


def load_ies(path: str) -> IESData:
    """Parse an IESNA LM-63 file (86/91/95/02 dialects)."""
    with open(path, "r", errors="replace") as f:
        text = f.read()

    lines = text.splitlines()
    i = 0
    # Header: keyword lines until TILT= (the 1986 dialect has free-form
    # header lines, later ones [KEYWORD] lines; both end at TILT=).
    while i < len(lines) and "TILT=" not in lines[i].upper():
        i += 1
    if i >= len(lines):
        raise ValueError(f"{path}: no TILT= line — not an LM-63 file")
    tilt = lines[i].upper().split("TILT=", 1)[1].strip()
    i += 1

    # Everything after TILT is whitespace-separated numbers.
    toks = " ".join(lines[i:]).split()
    pos = 0

    def take(n):
        nonlocal pos
        vals = [float(t) for t in toks[pos : pos + n]]
        if len(vals) != n:
            raise ValueError(f"{path}: truncated numeric data")
        pos += n
        return vals

    if tilt == "INCLUDE":
        take(1)  # lamp-to-luminaire geometry
        (n_tilt,) = take(1)
        take(2 * int(n_tilt))  # tilt angles + multiplying factors

    (num_lamps, lumens, mult, num_v, num_h, ptype, _units, _w, _l, _h) = take(10)
    (ballast, ballast_photometric, _watts) = take(3)
    num_v, num_h = int(num_v), int(num_h)
    v_angles = np.asarray(take(num_v), np.float32)
    h_angles = np.asarray(take(num_h), np.float32)
    candela = np.asarray(take(num_v * num_h), np.float32).reshape(num_h, num_v)

    mult = mult if mult > 0.0 else 1.0
    mult *= (ballast if ballast > 0.0 else 1.0) * (
        ballast_photometric if ballast_photometric > 0.0 else 1.0
    )
    return IESData(
        vertical_angles=v_angles,
        horizontal_angles=h_angles,
        candela=candela,
        multiplier=float(mult),
        photometric_type=int(ptype),
        lumens_per_lamp=float(lumens),
        num_lamps=int(num_lamps),
    )


def _expand_symmetry(data: IESData) -> tuple[np.ndarray, np.ndarray]:
    """Expand LM-63 symmetry shorthand to full 0..360 horizontal coverage
    (the Type A/B/C cases of ``Picture::createIES``, Picture.cpp:1343-1365).

    Returns (h_angles_full [Hf] covering [0, 360], candela_full [Hf, V]).
    """
    h = data.horizontal_angles.astype(np.float64)
    c = data.candela.astype(np.float64)
    lo, hi = float(h[0]), float(h[-1])

    if data.photometric_type in (2, 3):  # Type A/B: angles in [-90, 90]
        if lo == 0.0 and hi == 90.0:  # bilateral symmetry
            h = np.concatenate([-h[::-1][:-1], h])
            c = np.concatenate([c[::-1][:-1], c], axis=0)
        # shift [-90, 90] onto [90, 270] so "straight down" conventions align
        h = h + 180.0
        return h, c

    # Type C
    if hi <= 0.0 or len(h) == 1:  # rotationally symmetric
        return np.asarray([0.0, 360.0]), np.vstack([c[0], c[0]])
    if hi == 90.0:  # quadrant symmetry: mirror to 180, then to 360
        h2 = np.concatenate([h, 180.0 - h[::-1][1:]])
        c2 = np.concatenate([c, c[::-1][1:]], axis=0)
        h3 = np.concatenate([h2, 360.0 - h2[::-1][1:]])
        c3 = np.concatenate([c2, c2[::-1][1:]], axis=0)
        return h3, c3
    if hi == 180.0:  # bilateral: mirror about the 0-180 plane
        h2 = np.concatenate([h, 360.0 - h[::-1][1:]])
        c2 = np.concatenate([c, c[::-1][1:]], axis=0)
        return h2, c2
    if lo == 90.0 and hi == 270.0:  # bilateral about the 90-270 plane
        h2 = np.concatenate([h[0] - (h[::-1][1:] - h[0]), h])
        c2 = np.concatenate([c[::-1][1:], c], axis=0)
        h2 = np.mod(h2, 360.0)
        order = np.argsort(h2)
        return h2[order], c2[order]
    return h, c  # no symmetry: data covers the full circle


def ies_to_texture(data: IESData, width: int = 256, height: int = 128) -> np.ndarray:
    """Resample photometry onto a regular lat-long grid [height, width] f32.

    Rows run over vertical angle 0..180 deg (row 0 = nadir, matching the
    sampler's v = acos(-R.y)/pi), columns over azimuth [0, 360) with wrap.
    Candela values are premultiplied by the LM-63 multiplier/ballast factors
    (``Picture::generateIES``, Picture.cpp:1374-1380).
    """
    h_full, c_full = _expand_symmetry(data)
    v_angles = data.vertical_angles.astype(np.float64)

    # target grid (texel centers)
    tv = (np.arange(height) + 0.5) / height * 180.0
    tu = (np.arange(width) + 0.5) / width * 360.0

    # interpolate along vertical angles first (outside the measured range the
    # luminaire emits nothing)
    cv = np.zeros((c_full.shape[0], height))
    for j in range(c_full.shape[0]):
        cv[j] = np.interp(tv, v_angles, c_full[j], left=0.0, right=0.0)
    in_range = (tv >= v_angles[0] - 1e-6) & (tv <= v_angles[-1] + 1e-6)
    cv *= in_range[None, :]

    # then along horizontal angles with wrap-around
    hh = np.concatenate([h_full, [h_full[0] + 360.0]])
    cc = np.concatenate([cv, cv[:1]], axis=0)
    tu_adj = np.where(tu < hh[0], tu + 360.0, tu)
    tu_adj = np.clip(tu_adj, hh[0], hh[-1])
    out = np.stack(
        [np.interp(tu_adj, hh, cc[:, r]) for r in range(height)], axis=0
    )
    return (out * data.multiplier).astype(np.float32)
