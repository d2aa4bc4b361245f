"""roofline.cache_kernels: the cache kernels' least time over their device
time, in %. Each launch's least time is the larger of its bytes over 3.35
TB/s and its operations over the peak of their precision, counted from each
traced frame's launch shapes (its training tile sets the inference rows) (``nrc_bench/work.py``); the device time is the same
launches' in the trace, with K4's reduction of partial sums. Nothing is
read when the trace holds another set of launches than the frame's."""

from nrc_bench import work

LAYER = "kernels"
UNIT = "%"
MOVES = "frame_ms"
EXTRA = ("K4/K5 reduce_partials",)


def read(run):
    if run.trace is None:
        return None
    net = run.network
    frames = [work.cache_launches(net["encoding"], q, run.batch, run.batches, net) for q in run.traced_queries]
    device_us = 0.0
    for g, n in work.groups_of(frames[0]).items():
        got = run.trace.launches(g)
        if len(got) != n * len(frames):
            return None
        device_us += sum(got)
    for g in EXTRA:
        device_us += sum(run.trace.launches(g))
    least_ms = sum(ms for launches in frames for _, ms in launches)
    return 100.0 * least_ms / (device_us / 1e3) if device_us > 0 else None
