"""The benchmark on the card, end to end: one short traced run of each
cell as the command line runs it (``python3 -m pytest nrc_bench/tests -m
cuda``, from the checkout's root, on a machine with a card)."""

import json
import subprocess
import sys

import pytest

from nrc_bench import registry

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark()["workloads"]])
def test_a_short_traced_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "nrc_bench.run", "--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "3",
         "--trace", "1"], cwd=registry.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    names = {m["name"] for m in registry.metrics_of(registry.benchmark(), cell, "per_layer")}
    assert set(line["metrics"]) <= names and line["breakdown"]["device_ops"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
