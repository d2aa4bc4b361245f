"""renderer.host_ms: the host's ms in ``Renderer.render_frame`` (camera
upload, binning, graph dispatch, the wait of the stats read back two frames
late), mean over the window's frames, on the host clock."""

LAYER = "renderer"
UNIT = "ms"
MOVES = "frame_ms_p95"


def read(run):
    return sum(run.host_ms) / len(run.host_ms)
