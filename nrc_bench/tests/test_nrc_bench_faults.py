"""The check fails what it must: the control (the reference in fp8 in the
program's place) and runs with the timed path broken underneath, each held
to the cell's own limits (``limits/<cell>.json``), at a size a CPU test
can hold."""

import pytest
import torch

from nrc_bench import check, registry, scenes, system
from nrc_bench.calibrate import half_batch
from nrc_tpu_torch.models import network as PN
from nrc_tpu_torch.render import renderer as PR

from .test_nrc_bench_run import SMALL, small_run

CELL = "box-freq.still"


def fails(checks: dict) -> list:
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("cell", ["box-freq.still", "objects-hash.drag"])
def test_the_control_is_not_correct(cell):
    """The same frame from the same state, by the reference with fp8
    operands, against the reference with the configured bf16."""
    c = registry.workload(registry.benchmark(), cell)
    config = dict(registry.config(c["config"]), **SMALL)
    data = scenes.build(config["scene"], tuple(config["resolution"]))
    data.system["tile_size"] = tuple(config["tile_size"])
    dev = torch.device("cpu")
    r = system.make_renderer(data, config["network"], dev, 99)
    for _ in range(3):
        r.render_frame()
    pixels = torch.arange(r.cfg.num_pixels)
    b = check.before(r, pixels)
    frame, ref = check.reference_frame(data, config["network"], b, pixels, dev)
    ctl, ctl_state = check.reference_frame(data, config["network"], b, pixels, dev, operands="fp8")
    numbers = check.compare(b, check.as_after(ctl, ctl_state), frame, ref)
    limits = registry.limits(cell)
    assert fails({k: {"value": numbers[k], "limit": limits[k]} for k in numbers if k in limits})


def no_step(train_frame):
    """A fault: the frame's steps leave the state as it was."""
    def fault(state, batch_q, *a, **kw):
        return torch.zeros(batch_q.shape[0], device=batch_q.device)
    return fault


def altered_row(frame_step):
    """A fault: one image row of each frame scaled by 1.01 where it is made."""
    def fault(scene, net_state, image, camera, it, sub, cfg, *a, **kw):
        out, stats = frame_step(scene, net_state, image, camera, it, sub, cfg, *a, **kw)
        row = cfg.height // 2
        scale = torch.ones_like(out)
        scale[row * cfg.width:(row + 1) * cfg.width] = 1.01
        return out * scale, stats
    return fault


@pytest.mark.parametrize("fault", ["no_step", "half_batch", "altered_row"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    if fault == "altered_row":
        monkeypatch.setattr(PR, "frame_step", altered_row(PR.frame_step))
    else:
        monkeypatch.setattr(PN, "train_frame", {"no_step": no_step, "half_batch": half_batch}[fault](PN.train_frame))
    out = small_run(CELL, seconds=0.3)
    assert out["correct"] is False, out["checks"]
    assert fails(out["checks"])
