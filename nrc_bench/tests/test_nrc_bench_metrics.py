"""The metric arithmetic on recorded timestamps and shapes."""

import math
from types import SimpleNamespace

import pytest

from nrc_bench import registry, trace, work

FREQ = dict(encoding="frequency", n_neurons=64, n_hidden_layers=5, freq_n_frequencies=12, oneblob_n_bins=4)
HASH = dict(encoding="hash", n_neurons=64, n_hidden_layers=5, oneblob_n_bins=4, hash_n_levels=16,
            hash_n_features_per_level=2, hash_log2_size=15, hash_base_resolution=16, hash_per_level_scale=2.0)


def read(name, run):
    return registry.metric_reader(name).read(run)


def window(intervals):
    ms = sum(intervals)
    return SimpleNamespace(frames=len(intervals), window_ms=ms, intervals_ms=intervals, frame_ms=ms / len(intervals))


def test_frame_ms_is_the_window_over_its_frames():
    run = window([100.0] * 199 + [300.0])
    assert read("frame_ms", run) == pytest.approx(20200.0 / 200)


def test_p95_is_the_nearest_rank_over_every_interval():
    intervals = [float(i) for i in range(1, 201)]  # 1..200 ms
    assert read("frame_ms_p95", window(intervals)) == 190.0  # ceil(0.95 * 200) = 190th
    # ten stalls among 200 frames: the 95th percentile is still a plain frame
    assert read("frame_ms_p95", window([100.0] * 190 + [400.0] * 10)) == 100.0
    # eleven lift it to a stall
    assert read("frame_ms_p95", window([100.0] * 189 + [400.0] * 11)) == 400.0


def test_busy_is_the_union_and_idle_the_rest_of_the_wall():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25.0
    tr = trace.Trace(device=[("k", "kernel", 0.0, 10.0), ("k", "kernel", 5.0, 10.0), ("m", "gpu_memcpy", 20.0, 10.0)],
                     host=[("cudaGraphLaunch", 14.0, 5.0), ("render_frame", 10.0, 20.0)], frames=1, wall_us=50.0)
    assert read("device.idle_share", SimpleNamespace(trace=tr)) == pytest.approx(100.0 * (1 - 25.0 / 50.0))
    assert tr.idle_gaps() == [["cudaGraphLaunch", 5e-6]]  # the gap 15..20, mid 17.5, innermost call
    assert tr.top_ops(1) == [["k", 20e-6]]


def test_groups_split_the_device_time():
    tr = trace.Trace(device=[("void planes_kernel<false>(...)", "kernel", 0, 2000.0),
                             ("void wbvh_kernel<false, TriLeaf>(...)", "kernel", 0, 1000.0),
                             ("mlp_forward_kernel", "kernel", 0, 500.0),
                             ("hash_lookup_kernel", "kernel", 0, 250.0),
                             ("at::native::elementwise_kernel", "kernel", 0, 4000.0)],
                     host=[], frames=2, wall_us=1.0)
    run = SimpleNamespace(trace=tr)
    assert read("intersect.device_ms", run) == pytest.approx(1.5)
    assert read("cache.device_ms", run) == pytest.approx(0.375)
    assert read("integrator.glue_ms", run) == pytest.approx(2.0)
    assert read("integrator.glue_ms", SimpleNamespace(trace=None)) is None


def test_mlp_and_hash_bounds_from_shapes():
    # the network's own widths: 66 encoded inputs and the ones channel, 5 x 64, 3 outputs
    dims = 3 * 12 + 6 * 4 + 6
    macs = (dims + 1) * 64 + 4 * 64 * 64 + 64 * 3
    assert work.num_params(FREQ) == macs
    k3 = work.mlp_work("K3", 1000, FREQ)
    assert k3 == dict(nbytes=4 * 1000 * (dims + 3) + 4 * macs, ops=2 * macs * 1000)
    k4 = work.mlp_work("K4", 1000, HASH)
    assert k4["nbytes"] == 4 * 1000 * (2 * 62 + 3) + 8 * work.num_params(HASH)
    k6 = work.mlp_work("K6", 16384, FREQ, 4)
    assert k6["ops"] == 4 * 2 * (3 * macs - (dims + 1) * 64) * 16384
    h = work.hash_work(16384, 16, 15, 2)
    assert h["nbytes"] == 16384 * 12 + 16384 * 16 * 2 * 4 + 16 * 2 ** 15 * 2 * 4
    assert work.least_ms(k3, work.BF16_OPS_PER_S) == pytest.approx(1e3 * k3["nbytes"] / 3.35e12)
    assert [g for g, _ in work.cache_launches("frequency", 100, 16384, 4, FREQ)] == \
        ["K3 nrc_mlp_forward", "K6 nrc_mlp_train4"]
    counts = work.groups_of(work.cache_launches("hash", 100, 16384, 4, HASH))
    assert counts == {"K3 nrc_mlp_forward": 5, "H1 nrc_hash_lookup": 5, "K4 nrc_mlp_backward": 4,
                      "H2 nrc_hash_adjoint": 4}


def test_roofline_reads_its_launches_and_nothing_else():
    launches = work.cache_launches("frequency", 2_000_000, 16384, 4, FREQ)
    least = sum(ms for _, ms in launches)
    dev = [("mlp_forward_kernel", "kernel", 0.0, 1000.0 * launches[0][1] * 2),
           ("mlp_train4_kernel", "kernel", 0.0, 1000.0 * launches[1][1] * 4)]
    run = SimpleNamespace(trace=trace.Trace(dev, [], 1, 1.0), network=FREQ, traced_queries=[2_000_000], batch=16384,
                          batches=4)
    share = read("roofline.cache_kernels", run)
    assert share == pytest.approx(100.0 * least / (2 * launches[0][1] + 4 * launches[1][1]))
    assert 0 < share <= 100
    run.trace = trace.Trace(dev[:1], [], 1, 1.0)  # K6 missing: another set of launches
    assert read("roofline.cache_kernels", run) is None


def test_mfu_from_shapes():
    run = SimpleNamespace(queries=[2_000_000, 2_500_000], batch=16384, batches=4, network=FREQ, window_ms=200.0)
    dims = 3 * 12 + 6 * 4 + 6
    flops = 2 * ((dims + 1) * 64 + 4 * 64 * 64 + 64 * 3) * (4_500_000 + 2 * 3 * 4 * 16384)
    assert read("mfu.frame", run) == pytest.approx(100 * flops / (0.2 * 989e12))
    assert math.isclose(work.frame_model_flops(1, 0, 4, HASH), 2 * ((32 + 30 + 1) * 64 + 4 * 4096 + 192))
