"""frame_ms_p95: the 95th percentile (nearest rank) of every frame's
interval in the window, each taken between consecutive end events (the
first from the window's start event): the stutter a viewer sees; host
stalls, captures and idle gaps all land in it."""

import math

LAYER = None
UNIT = "ms"
MOVES = None


def read(run):
    v = sorted(run.intervals_ms)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]
