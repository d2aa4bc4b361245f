"""The live viewer over ranks: ``--present --devices N``
(``nrc_tpu_torch/app/cli.py::_present_loop``, ``_PassExchange``,
``_run_ranks``) on gloo CPU ranks.

- The CLI in a child process, ``--present --devices 2 --device cpu --port 0``
  on 16x16 Cornell files (8x8 tiles), driven over HTTP as a page would by
  ``nrc_tpu_torch/tools/present_page.py`` (which also drives
  ``chip_smoke.py`` 6j's two cards): each step of its ``SCRIPT`` (an orbit,
  a ``render_mode`` setting, a ``reset_cache`` and a ``screenshot_png``) is
  sent once the accumulation is full (a publication at ``SPP`` frames whose
  PNG differs from the last step's), so that both runs render the same
  frames. The screenshot must be bit for bit the one the single-rank loop
  writes for the same script (the last frames are NO_CACHE, whose bands are
  the whole frame's bit for bit); SIGINT to the CLI's process must end every
  rank with exit code 0. A rank that raises (a
  screenshot into a path under a file) ends the other: the CLI exits with
  an error, within a time limit.
- The present loop of two ranks, in ``tests/torch_ranks.py``'s processes, against
  the JAX CLI's ``_present_loop`` over its ``ParallelRenderer`` on 2 CPU
  devices (in a child process, ``test_torch_jax_child.run_jax_side``): the
  same script through the viewers' queues, the loop's idle wait patched to
  act as the page; the image after the last accumulation (NO_CACHE, no
  training) held as ``test_torch_shard.py``'s bands are, its rays logged per
  band (``test_torch_slice.ray_flips``) under the image bounds of
  ``test_torch_train_slice.SLICE_LIMITS``.
"""

import signal
import time
import types
from pathlib import Path

import numpy as np
import pytest

from nrc_tpu_torch.scene.scene_builder import write_cornell_box_files
from nrc_tpu_torch.tools.present_page import SCRIPT, STEP_TIMEOUT_S, PresentCli, run_script
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_jax_child import run_jax_side
from test_torch_shard import (
    _log_entries,
    _prefixed,
    _recording_intersectors,
    band_image_readings,
    jax_band_entries,
    jax_band_intersectors,
)
from torch_ranks import run_ranks

RES = (16, 16)
SPP = 2


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell")
    system, scene = write_cornell_box_files(str(d), RES)
    text = Path(system).read_text()
    assert "tileSize 16 16" in text
    Path(system).write_text(text.replace("tileSize 16 16", "tileSize 8 8"))  # 8-row bands
    return system, scene


def _present(files, tmp_path, name, devices):
    """``SCRIPT`` through the CLI's viewer (``present_page.run_script``):
    the screenshot's bytes, the exit code after SIGINT, the output and the
    errors."""
    argv = ["-s", files[0], "-d", files[1], "--device", "cpu"] + (["--devices", str(devices)] if devices > 1 else [])
    return run_script(argv, tmp_path / name, SPP)


def test_two_ranks_present_the_screenshot_of_one(files, tmp_path):
    one, code, _, err = _present(files, tmp_path, "one", 1)
    assert code == 0, err[-4000:]
    two, code, out, err = _present(files, tmp_path, "two", 2)
    assert code == 0, err[-4000:]
    assert out.count("presenting at ") == 1 and out.count("spp in ") == 1  # rank 0 alone serves and prints
    assert two == one


def test_a_rank_that_raises_ends_the_other(files, tmp_path):
    (tmp_path / "a_file").write_text("")
    cli = PresentCli(["-s", files[0], "-d", files[1], "--device", "cpu", "--devices", "2"],
                     tmp_path / "a_file" / "shot", 1)
    try:
        cli.get("action?op=screenshot_png")  # rank 0 raises: its prefix lies under a file
        code = cli.wait(STEP_TIMEOUT_S)
    finally:
        cli.close()
    err = "".join(cli.err)
    # the parent saw rank 0 fail, or both ended (rank 1's broadcast fails once rank 0 is gone)
    ended = "rank 0 of 2 failed" in err or "the ranks' exit codes: [1, " in err
    assert code != 0 and ended and "NotADirectoryError" in err, err[-4000:]


# ---------------------------------------------------------------------------
# against the JAX CLI's present loop over its ParallelRenderer
# ---------------------------------------------------------------------------

def _page(queues, done):
    """The page of the in-process loops, called at each idle wait (the
    accumulation is full): the next step of ``SCRIPT`` (the screenshot left
    out) into the viewer's queues ``queues()`` = (events, settings,
    actions); after the last step's frames, ``done()``."""
    steps = iter(SCRIPT[:-1])

    def page():
        step = next(steps, None)
        if step is None:
            return done()
        endpoint, query = step
        q = dict(kv.split("=") for kv in query.split("&"))
        events, settings, actions = queues()
        if endpoint == "control":
            events.put((q["op"], (float(q["dx"]), float(q["dy"]), 0.0)))
        elif endpoint == "set":
            settings.put({"key": q["key"], "value": q["value"], "material": None})
        else:
            actions.put(q["op"])
    return page


def _argv(system, scene, world, output):
    return ["-s", str(system), "-d", str(scene), "--present", "--port", "0", "--spp", str(SPP), "--no-train",
            "--devices", str(world), "--output", str(output)]


def present_rank(rank, world, system, scene, output):
    """The port's present loop on this rank (``cli._run``): rank 0's idle
    wait acts as the page and ends the loop with SIGINT; every rank's rays
    logged, the log cleared where the cache is reset, so that it holds the
    last accumulation's frames."""
    import torch

    import nrc_tpu_torch.render.integrator as port_integrator
    from nrc_tpu_torch.app import cli
    from nrc_tpu_torch.parallel import shard as S

    log, made, held = [], [], {}
    real_viewer, real_reset, real_loop = cli.Viewer, S.ParallelRenderer.reset_cache, cli._present_loop

    def viewer(*a, **kw):
        made.append(real_viewer(*a, **kw))
        return made[-1]

    def reset_cache(self, seed=0):
        log.clear()
        real_reset(self, seed)

    def loop(args, r, spp, t0):
        held["r"] = r
        return real_loop(args, r, spp, t0)

    page = _page(lambda: (made[0].events, made[0].settings, made[0].actions),
                 lambda: signal.raise_signal(signal.SIGINT))

    def idle(seconds):
        if rank == 0:
            page()
        time.sleep(seconds)

    cli.Viewer, cli._present_loop = viewer, loop
    cli.time = types.SimpleNamespace(sleep=idle, perf_counter=time.perf_counter)
    S.ParallelRenderer.reset_cache = reset_cache
    port_integrator.make_intersectors = _recording_intersectors(log)
    args = cli.build_parser().parse_args(_argv(system, scene, world, output))
    assert cli._run(args, torch.device("cpu"), rank, world) == 0
    r = held["r"]
    out = {"image": r.image.numpy().copy(), "iteration": r.iteration, "mode": r.cfg.render_mode.name}
    out.update(_log_entries(log, "log"))
    return out


def jax_present(system, scene, world, output):
    """The JAX CLI, ``--present --devices 2 --no-train``: its present loop
    over its ``ParallelRenderer``, the idle wait acting as the page, each
    band's rays logged (unordered callbacks with the band's index), the log
    cleared where the cache is reset; the image after the loop."""
    import jax

    import nrc_tpu.render.integrator as jax_integrator
    from nrc_tpu.app import cli as jcli
    from nrc_tpu.app import viewer as jviewer
    from nrc_tpu.render.renderer import Renderer as JRenderer

    logs, made, held = {}, [], {}
    real_viewer, real_reset, real_loop = jviewer.Viewer, JRenderer.reset_cache, jcli._present_loop

    def viewer(*a, **kw):
        made.append(real_viewer(*a, **kw))
        return made[-1]

    def reset_cache(self, *a, **kw):
        jax.effects_barrier()
        logs.clear()
        return real_reset(self, *a, **kw)

    def loop(args, parallel, r, spp, t0):
        held["r"] = r
        return real_loop(args, parallel, r, spp, t0)

    def stop():
        raise KeyboardInterrupt

    page = _page(lambda: (made[0].events, made[0].settings, made[0].actions), stop)

    def idle(seconds):
        page()
        time.sleep(seconds)

    jax_integrator.make_intersectors = jax_band_intersectors(logs)
    jviewer.Viewer, jcli._present_loop = viewer, loop
    jcli.time = types.SimpleNamespace(sleep=idle, perf_counter=time.perf_counter)
    JRenderer.reset_cache = reset_cache
    assert jcli.main(_argv(system, scene, int(world), output)) == 0
    jax.effects_barrier()
    r = held["r"]
    out = {"image": np.asarray(r.image), "iteration": np.int64(r.iteration), "mode": r.cfg.render_mode.name}
    out.update(jax_band_entries(logs, "log."))
    return out


def test_sharded_loop_matches_the_jax_present_loop(files, tmp_path):
    from test_torch_train_slice import SLICE_LIMITS

    world = 2
    ref = run_jax_side("test_torch_present_ranks:jax_present", tmp_path, system=np.asarray(files[0]),
                       scene=np.asarray(files[1]), world=np.int32(world), output=np.asarray(str(tmp_path / "jax")))
    ranks = run_ranks("test_torch_present_ranks:present_rank", world, tmp_path, system=files[0], scene=files[1],
                      output=str(tmp_path / "port"))
    for r in ranks:
        assert int(r["iteration"]) == int(ref["iteration"]) == SPP and str(r["mode"]) == str(ref["mode"]) == "NO_CACHE"
    got = band_image_readings(_prefixed(ref, "image", "log."), ranks)
    print(f"the sharded present loop against JAX's: {got}")
    over = {k: (v, SLICE_LIMITS[k]) for k, v in got.items() if not v <= SLICE_LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
