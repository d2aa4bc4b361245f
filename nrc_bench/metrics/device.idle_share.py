"""device.idle_share: 1 - busy / wall over the traced frames, in %. Busy
is the union of the trace's kernel, memcpy and memset intervals; the wall
is the host's clock from a synchronize before the first traced frame to
the synchronize after the last."""

LAYER = "device"
UNIT = "%"
MOVES = "frame_ms"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.wall_us)
