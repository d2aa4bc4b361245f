"""A configuration, a traffic mix, a metric or a cell is found by its name
from files alone: copy the harness, add files, edit nothing."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from nrc_bench import registry

HERE = Path(registry.__file__).resolve().parent
ROOT = HERE.parent


def test_every_name_of_the_benchmark_has_its_file():
    bench = registry.benchmark()
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"nrc_bench/configs/{c['name']}.json" and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        registry.traffic(w["traffic"])
        assert set(registry.limits(w["name"])) >= {"init_max_abs", "pixels_apart_ppm", "loss_gap", "weights_gap"}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            reader = registry.metric_reader(m["name"])
            assert reader.UNIT == m["unit"]
            if kind == "per_layer":
                assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_new_files_are_found_without_an_edit(tmp_path):
    copy = tmp_path / "nrc_bench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cfg = json.loads((copy / "configs" / "box-freq.json").read_text())
    cfg["name"] = "box-new"
    (copy / "configs" / "box-new.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "slow_drag.json").write_text(json.dumps(
        {"orbit_turns": [0.001, 0.0], "restart_every_frame": True, "phase_from_seed": False, "warmup_frames": 2}))
    (copy / "limits" / "box-new.slow_drag.json").write_text(json.dumps(
        {"init_max_abs": 0.0, "pixels_apart_ppm": 1, "loss_gap": 1.0, "weights_gap": 1.0}))
    (copy / "metrics" / "renderer.frames.py").write_text(textwrap.dedent('''
        LAYER = "renderer"
        UNIT = "frames"
        MOVES = "frame_ms"


        def read(run):
            return run.frames
        '''))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "box-new", "source": "x", "file": "nrc_bench/configs/box-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "box-new.slow_drag", "config": "box-new", "traffic": "slow_drag",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "renderer.frames", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "renderer", "moves": "frame_ms",
                               "workloads": ["box-new.slow_drag"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, data in before.items():
        assert p.read_bytes() == data  # nothing that was there is edited
    code = textwrap.dedent('''
        from types import SimpleNamespace
        from nrc_bench import registry
        from nrc_bench.traffic import Traffic
        bench = registry.benchmark()
        cell = registry.workload(bench, "box-new.slow_drag")
        assert registry.config(cell["config"])["name"] == "box-new"
        assert Traffic.from_params(registry.traffic(cell["traffic"])).orbit_turns == (0.001, 0.0)
        assert registry.limits(cell["name"])["pixels_apart_ppm"] == 1
        names = [m["name"] for m in registry.metrics_of(bench, cell["name"], "per_layer")]
        assert "renderer.frames" in names
        assert "renderer.frames" not in [m["name"] for m in registry.metrics_of(bench, "box-freq.still", "per_layer")]
        assert registry.metric_reader("renderer.frames").read(SimpleNamespace(frames=7)) == 7
        print("found")
        ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "found"
