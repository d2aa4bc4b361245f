"""The traffic generator: what happens to the camera between frames."""

import pytest

from nrc_bench import registry
from nrc_bench.traffic import Traffic


class Camera:
    def __init__(self, phi=0.75, theta=0.5):
        self.phi, self.theta = phi, theta

    def orbit(self, dx, dy):  # as the port's Camera.orbit
        self.phi = (self.phi - dx) % 1.0
        self.theta = min(max(self.theta + dy, 0.0), 1.0)


class Renderer:
    def __init__(self):
        self.scene = type("Scene", (), {})()
        self.scene.camera = Camera()
        self.restarts = 0

    def restart_accumulation(self):
        self.restarts += 1


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 3_600_000_004])
def test_the_drag_sweeps_across_the_view_and_never_back_to_the_first(seed):
    mix = Traffic.from_params(registry.traffic("drag"))
    r = Renderer()
    mix.start(r.scene.camera, seed)
    mix.before_frame(r)
    first = r.scene.camera.phi  # the run's first frame, which the renderer bins
    seen = []
    for _ in range(499):
        mix.before_frame(r)
        seen.append(r.scene.camera.phi)
    assert r.restarts == 500
    assert all(abs(p - 0.75) <= mix.sweep_turns + 1e-9 for p in seen)
    assert min(abs(p - first) for p in seen) >= 0.5 * mix.orbit_turns[0] - 1e-9
    assert len({round(p, 6) for p in seen}) == 10  # to and fro over 0.705 .. 0.795


def test_the_still_mix_holds_the_camera():
    mix = Traffic.from_params(registry.traffic("still"))
    r = Renderer()
    mix.start(r.scene.camera, 7)
    for _ in range(20):
        mix.before_frame(r)
    assert (r.scene.camera.phi, r.scene.camera.theta, r.restarts) == (0.75, 0.5, 0)
