"""A run end to end on the CPU at a small size (the harness's look for a
card skipped): the last line's keys, the reference against the program, the
imports, and a run with the timed path broken underneath, which the check
must call not correct."""

import json
import subprocess
import sys
import textwrap

import torch

from nrc_bench import registry
from nrc_bench import run as R

SMALL = dict(resolution=[48, 32], tile_size=[2, 2])


def small_run(cell="box-freq.still", seed=2 ** 31 + 17, seconds=0.5, trace=False, limits=None):
    bench = registry.benchmark()
    c = registry.workload(bench, cell)
    config = dict(registry.config(c["config"]), **SMALL)
    return R.run_cell(bench, c, seed, seconds, trace, torch.device("cpu"), config=config, limits=limits,
                      tiles=(2, 4), log=lambda *a, **k: None)


def test_last_line_keys_and_a_sound_run():
    out = small_run(trace=True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the reference is the program's own plain path: bit for bit
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        "init_max_abs": 0.0, "pixels_apart_ppm": 0, "loss_gap": 0.0, "weights_gap": 0.0}
    assert "renderer.host_ms" in out["metrics"] and "frame_ms" not in out["metrics"]
    json.dumps(out)
    e2e = small_run(trace=False)
    assert set(e2e["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert "breakdown" not in e2e


def test_no_card_no_result(tmp_path):
    code = "import sys; from nrc_bench import run; sys.exit(run.main(['--workload', 'box-freq.still', " \
           "'--seed', '1', '--seconds', '1']))"
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = textwrap.dedent('''
        import sys, torch
        import nrc_bench.reference.render.frame, nrc_bench.reference.scene.build, nrc_bench.check
        tops = {m.split(".")[0] for m in sys.modules}
        assert not tops & {"nrc_tpu_torch", "nrc_tpu", "jax", "jaxlib", "flax"}, tops
        from nrc_bench import registry, run as R
        bench = registry.benchmark()
        c = registry.workload(bench, "box-freq.still")
        config = dict(registry.config(c["config"]), resolution=[16, 16], tile_size=[4, 4])
        R.run_cell(bench, c, 5, 0.1, False, torch.device("cpu"), config=config, tiles=(4,), log=lambda *a, **k: None)
        assert "nrc_tpu_torch" in sys.modules
        assert R.forbidden_modules() == [], R.forbidden_modules()
        sys.modules["nrc_tpu"] = object()
        assert R.forbidden_modules() == ["nrc_tpu"]
        print("clean")
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")
