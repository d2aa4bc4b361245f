"""mfu.frame: the window's model operations over its time (frame_ms times
the frames) times 989 TFLOP/s (the H100 SXM's dense bf16 peak at 700 W),
in %. A frame's operations are the MLP's from its unpadded shapes: a
forward on every query (the pixels and that frame's training tiles' ends)
and each training step's batch as forward + backward = 3 forwards
(``nrc_bench/work.py::frame_model_flops``)."""

from nrc_bench import work

LAYER = "device"
UNIT = "%"
MOVES = "frame_ms"


def read(run):
    flops = sum(work.frame_model_flops(q, run.batch, run.batches, run.network) for q in run.queries)
    return 100.0 * flops / (run.window_ms * 1e-3 * work.BF16_OPS_PER_S)
