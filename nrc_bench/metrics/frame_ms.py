"""frame_ms: the window's device time, from the first timed frame's start
event to the last frame's end event, over the frames completed in it."""

LAYER = None
UNIT = "ms"
MOVES = None


def read(run):
    return run.frame_ms
