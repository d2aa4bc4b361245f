"""setup_s: from the process's start to the first timed frame: imports,
the scene's arrays, the BVH, the upload, the kernels loaded or built, the
warm-up frames and their captures, and the raster's binning."""

LAYER = None
UNIT = "s"
MOVES = None


def read(run):
    return run.setup_s
