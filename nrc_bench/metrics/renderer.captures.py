"""renderer.captures: frames of the window that were not a graph replay
(each ran eagerly and captured a graph): frames minus ``Renderer.replays``
gained."""

LAYER = "renderer"
UNIT = "captures"
MOVES = "frame_ms_p95"


def read(run):
    return run.captures
