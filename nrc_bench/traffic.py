"""The one traffic generator: what the viewer does between two frames.

A mix is ``traffic/<name>.json`` with these parameters:
- ``orbit_turns`` [dx, dy]: the camera's orbit before every frame, in turns
  (``Camera.orbit``, as a drag in the viewer); [0, 0] holds it still;
- ``sweep_turns``: the drag turns back when it is that far from the
  scene's view, so that it sweeps to and fro across it (0: it goes on);
- ``restart_every_frame``: restart the accumulation before every frame, as
  the viewer does on a camera move;
- ``phase_from_seed``: start the drag at a place and in a direction drawn
  from the seed (the same sweep, entered elsewhere). The second step of a
  drag is half a step, so that the sweep never comes back to the very view
  of the run's first frame, which the renderer bins and rasters (a frame
  whose camera is that view again would raster, not walk);
- ``warmup_frames``: frames run in set-up before the window, enough for
  every graph the mix needs to be captured.
"""

from __future__ import annotations

import random


class Traffic:
    def __init__(self, orbit_turns, sweep_turns: float, restart_every_frame: bool, phase_from_seed: bool,
                 warmup_frames: int):
        self.orbit_turns = tuple(float(x) for x in orbit_turns)
        self.sweep_turns = float(sweep_turns)
        self.restart_every_frame = bool(restart_every_frame)
        self.phase_from_seed = bool(phase_from_seed)
        self.warmup_frames = int(warmup_frames)
        self.offset = 0.0      # turns of drag from the scene's view
        self.direction = 1.0
        self.shares = [1.0, 0.5]  # of a step, for the next frames; then 1

    @staticmethod
    def from_params(p: dict) -> "Traffic":
        return Traffic(p["orbit_turns"], p.get("sweep_turns", 0.0), p["restart_every_frame"], p["phase_from_seed"],
                       p["warmup_frames"])

    @property
    def moves(self) -> bool:
        return any(self.orbit_turns)

    def _step(self) -> float:
        """The next frame's share of a step of the drag, with its sign."""
        share = self.shares.pop(0) if self.shares else 1.0
        if self.sweep_turns > 0:
            step = share * (abs(self.orbit_turns[0]) or abs(self.orbit_turns[1]))
            if abs(self.offset + self.direction * step) > self.sweep_turns + 1e-12:
                self.direction = -self.direction
            self.offset += self.direction * step
        return self.direction * share

    def start(self, camera, seed: int) -> None:
        """The camera's place for the run: the scene's, or with
        ``phase_from_seed`` a place in the sweep and a direction drawn from
        ``seed``."""
        if self.moves and self.phase_from_seed:
            rng = random.Random(seed)
            k = abs(self.orbit_turns[0]) or abs(self.orbit_turns[1])
            steps = int(self.sweep_turns / k) if self.sweep_turns > 0 else 0
            n = rng.randint(-steps, steps)
            self.direction = rng.choice((-1.0, 1.0))
            self.offset = n * k
            camera.orbit(n * self.orbit_turns[0], n * self.orbit_turns[1])

    def before_frame(self, renderer) -> None:
        if self.moves:
            d = self._step()
            renderer.scene.camera.orbit(d * self.orbit_turns[0], d * self.orbit_turns[1])
        if self.restart_every_frame:
            renderer.restart_accumulation()
