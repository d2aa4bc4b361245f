"""integrator.rays_per_frame: ``Renderer.traced_rays`` over the window's
frames: live closest-hit segments plus valid shadow rays, both wavefronts,
summed on the device."""

LAYER = "frame and integrator"
UNIT = "rays"
MOVES = "frame_ms"


def read(run):
    return run.traced_rays / run.frames
