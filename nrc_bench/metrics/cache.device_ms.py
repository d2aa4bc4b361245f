"""cache.device_ms: device ms a traced frame of the cache network's
kernels: K3-K6 (with K4/K5's reduction of partial sums), H1 and H2."""

LAYER = "cache network"
UNIT = "ms"
MOVES = "frame_ms"
GROUPS = ("K3 nrc_mlp_forward", "K4 nrc_mlp_backward", "K5 nrc_mlp_train_grad", "K4/K5 reduce_partials",
          "K6 nrc_mlp_train4", "H1 nrc_hash_lookup", "H2 nrc_hash_adjoint")


def read(run):
    if run.trace is None:
        return None
    by = run.trace.device_us_by_group()
    us = [by[g] for g in GROUPS if g in by]
    return sum(us) / run.trace.frames / 1e3 if us else None
