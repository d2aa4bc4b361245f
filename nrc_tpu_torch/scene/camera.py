"""Orbit camera and the pinhole lens.

Port of ``nrc_tpu/scene/camera.py:27-138``: the host-side orbit camera that
produces the (P, U, V, W) frustum (reference ``nrc/src/Camera.cpp:170-199``)
and batched primary-ray generation for the three lenses, pinhole,
full-format fisheye and spherical (``nrc/shaders/lens_shader.cu:40-108``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..utils.math import normalize

LENS_PINHOLE = 0
LENS_FISHEYE = 1
LENS_SPHERE = 2


@dataclasses.dataclass
class Camera:
    """Orbit camera state (reference ``inc/Camera.h:37-95``)."""

    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    phi: float = 0.75      # [0,1], 0.75 = +z axis
    theta: float = 0.6     # [0,1], 0.5 = equator
    fov: float = 60.0      # degrees (y)
    distance: float = 10.0
    aspect: float = 1.0

    def frustum(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Return (P, U, V, W) float32[3] (``Camera.cpp:170-199``)."""
        cos_phi = math.cos(self.phi * 2.0 * math.pi)
        sin_phi = math.sin(self.phi * 2.0 * math.pi)
        cos_theta = math.cos(self.theta * math.pi)
        sin_theta = math.sin(self.theta * math.pi)

        normal = np.array(
            [cos_phi * sin_theta, -cos_theta, -sin_phi * sin_theta], np.float32
        )
        tan_fov_half = math.tan(math.radians(self.fov) * 0.5)

        p = np.asarray(self.center, np.float32) + self.distance * normal
        u = self.aspect * np.array([-sin_phi, 0.0, -cos_phi], np.float32) * tan_fov_half
        v = (
            np.array([cos_theta * cos_phi, sin_theta, cos_theta * -sin_phi], np.float32)
            * tan_fov_half
        )
        w = -normal
        return p, u, v, w


def generate_primary_rays(
    pixel_xy: torch.Tensor,
    sample: torch.Tensor,
    screen: tuple[int, int],
    cam_p: torch.Tensor,
    cam_u: torch.Tensor,
    cam_v: torch.Tensor,
    cam_w: torch.Tensor,
    lens: int = LENS_PINHOLE,
):
    """Batched primary rays: ``pixel_xy`` [N, 2] float pixel coords and
    ``sample`` [N, 2] jitter in [0,1) -> (org [N,3], dir [N,3]). The fisheye
    and sphere lenses span the camera's normalized basis u, v, w."""
    w, h = float(screen[0]), float(screen[1])
    frag = pixel_xy + sample
    org = cam_p.expand(frag.shape[:-1] + (3,)).contiguous()

    if lens == LENS_PINHOLE:
        ndc_x = (frag[..., 0] / w) * 2.0 - 1.0
        ndc_y = (frag[..., 1] / h) * 2.0 - 1.0
        d = ndc_x[..., None] * cam_u + ndc_y[..., None] * cam_v + cam_w
        return org, normalize(d)

    un, vn, wn = normalize(cam_u), normalize(cam_v), normalize(cam_w)
    if lens == LENS_FISHEYE:
        cx, cy = w * 0.5, h * 0.5
        clen = math.hypot(cx, cy)
        ux = (frag[..., 0] - cx) / clen
        uy = (frag[..., 1] - cy) / clen
        r = torch.sqrt(ux * ux + uy * uy)
        z = torch.cos(r * 0.7071067812 * 0.5 * math.pi)
        d = ux[..., None] * un + uy[..., None] * vn + z[..., None] * wn
        return org, normalize(d)

    if lens == LENS_SPHERE:
        phi = (frag[..., 0] / w) * 2.0 * math.pi
        theta = (frag[..., 1] / h) * math.pi
        st = torch.sin(theta)
        vx = -torch.sin(phi) * st
        vy = -torch.cos(theta)
        vz = -torch.cos(phi) * st
        d = vx[..., None] * un + vy[..., None] * vn + vz[..., None] * wn
        return org, normalize(d)

    raise ValueError(f"unknown lens {lens}")
