"""intersect.device_ms: device ms a traced frame of the intersection
kernels: K1, K2, W1, W2, R1, C1 and C2."""

LAYER = "intersection kernels"
UNIT = "ms"
MOVES = "frame_ms"
GROUPS = ("K1 nrc_planes_closest", "K2 nrc_planes_any", "W1 nrc_wbvh_closest", "W2 nrc_wbvh_any",
          "R1 nrc_raster_closest", "C1 nrc_wbvh_curves_closest", "C2 nrc_wbvh_curves_any")


def read(run):
    if run.trace is None:
        return None
    by = run.trace.device_us_by_group()
    us = [by[g] for g in GROUPS if g in by]
    return sum(us) / run.trace.frames / 1e3 if us else None
