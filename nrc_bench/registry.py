"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
the configuration ``configs/<name>.json``, the traffic mix
``traffic/<name>.json``, a metric's reader ``metrics/<name>.py`` and a
cell's limits ``limits/<cell>.json``. A later configuration, mix, metric or
cell is a new file and a new entry; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def limits(cell: str, here: Path = HERE) -> dict:
    return load_json(here / "limits" / f"{cell}.json")


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nrc_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
