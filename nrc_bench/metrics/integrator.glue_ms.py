"""integrator.glue_ms: device ms a traced frame of the kernels in no
hand-kernel group: PyTorch's own elementwise, gather, sort and reduction
kernels (``trace.GLUE``)."""

from nrc_bench.trace import GLUE

LAYER = "frame and integrator"
UNIT = "ms"
MOVES = "frame_ms"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.device_us_by_group().get(GLUE)
    return None if us is None else us / run.trace.frames / 1e3
