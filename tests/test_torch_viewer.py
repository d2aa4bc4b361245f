"""The live viewer of the port (``nrc_tpu_torch/app/viewer.py``), its
camera verbs (``scene/camera.py``) and the CLI's present loop
(``app/cli.py::_present_loop``), against the JAX package.

- Each camera verb, and sequences of them, leave the JAX ``Camera``'s fields
  bit for bit (the same float32 numpy arithmetic on both sides).
- Every endpoint of the server on an ephemeral port; the events a page sends
  (``/control``) drained by the port's ``Viewer.drain_events`` and applied
  to a camera by ``apply_camera_events``, and by the JAX ``Viewer``'s,
  fields bit for bit.
- ``_gui_params`` and ``_apply_setting`` against the JAX functions on
  renderers of the same Cornell files, bad edits included (each is printed
  and dropped, on both sides alike).
- The present loop on the CPU at 32x32 on the files
  ``write_cornell_box_files`` writes: ``time.sleep`` (the loop's idle wait
  once ``spp`` frames are accumulated) is patched to act as a page would: it
  fetches the published PNG, which must decode to ``tonemap_to_u8`` of the
  image, sends an orbit, which must restart the accumulation, and a
  screenshot action, which must write the file; then it raises
  ``KeyboardInterrupt``, which ends the loop as ctrl-c does. The loop's
  renderer is freed by reference counting once the loop has ended.
"""

import contextlib
import gc
import io
import json
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from nrc_tpu.app import cli as jcli
from nrc_tpu.app.viewer import Viewer as JViewer
from nrc_tpu.scene.camera import Camera as JCamera
from nrc_tpu_torch.app import cli
from nrc_tpu_torch.app.viewer import Viewer, apply_camera_events
from nrc_tpu_torch.scene.camera import Camera
from nrc_tpu_torch.scene.scene_builder import write_cornell_box_files
from nrc_tpu_torch.utils.image_io import decode_png, encode_png, write_png
from nrc_tpu_torch.utils.tonemap import tonemap_to_u8
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

FIELDS = ("center", "phi", "theta", "fov", "distance", "aspect")
START = dict(center=(0.5, -1.25, 2.0), phi=0.75, theta=0.6, fov=45.0, distance=12.5, aspect=1.5)
VERBS = [
    ("orbit", (0.1, -0.05)), ("orbit", (-1.3, 0.9)), ("orbit", (0.25, -2.0)),
    ("dolly", (3.0,)), ("dolly", (40.0,)), ("dolly", (-7.5,)),
    ("pan", (0.2, -0.1)), ("pan", (-0.03, 0.4)),
    ("zoom", (5.0,)), ("zoom", (-200.0,)), ("zoom", (300.0,)),
    ("focus", ((1.0, 2.0, -3.0),)), ("focus", ((0.0, 0.0, 0.0),)), ("focus", ((50.0, -20.0, 100.0),)),
]


def _fields(cam):
    return tuple(getattr(cam, f) for f in FIELDS)


@pytest.mark.parametrize("verb, args", VERBS, ids=[f"{v}{i}" for i, (v, _) in enumerate(VERBS)])
def test_each_verb_matches_jax(verb, args):
    port, ref = Camera(**START), JCamera(**START)
    getattr(port, verb)(*args)
    getattr(ref, verb)(*args)
    assert _fields(port) == _fields(ref)
    for a, b in zip(port.frustum(), ref.frustum()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_verb_sequences_match_jax(seed):
    rs = np.random.default_rng(seed)
    port, ref = Camera(**START), JCamera(**START)
    for _ in range(40):
        verb, args = VERBS[rs.integers(len(VERBS))]
        if verb != "focus":
            args = tuple(float(a * rs.uniform(-1.5, 1.5)) for a in args)
        getattr(port, verb)(*args)
        getattr(ref, verb)(*args)
        assert _fields(port) == _fields(ref), verb


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


@pytest.fixture
def viewer():
    v = Viewer(port=0)
    try:
        yield v
    finally:
        v.close()


def test_every_endpoint(viewer):
    base = viewer.url
    assert base.startswith("http://127.0.0.1:") and viewer.port > 0
    status, ctype, body = _get(base)
    assert status == 200 and ctype == "text/html" and b"/frame.png" in body and b"/control?op=" in body
    assert _get(base + "frame.png")[2] == b""
    png = encode_png(np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3))
    viewer.publish(png, 3, 12.5, 0.25, loss_history=[1.0, 0.5])
    status, ctype, body = _get(base + "frame.png")
    assert ctype == "image/png" and body == png
    assert json.loads(_get(base + "stats")[2]) == {"iteration": 3, "fps": 12.5, "loss": 0.25,
                                                    "loss_history": [1.0, 0.5]}
    viewer.params_provider = lambda: {"render_mode": "FULL"}
    assert json.loads(_get(base + "params")[2]) == {"render_mode": "FULL"}

    def broken():
        raise RuntimeError("gone")
    viewer.params_provider = broken
    assert "gone" in json.loads(_get(base + "params")[2])["error"]
    for q in ("op=orbit&dx=0.1&dy=-0.2", "op=pan&dx=0.3&dy=0.1", "op=dolly&d=1", "op=zoom&d=-1", "op=spin&d=1"):
        assert _get(base + "control?" + q)[2] == b"ok"
    assert [viewer.events.get_nowait() for _ in range(4)] == [
        ("orbit", (0.1, -0.2, 0.0)), ("pan", (0.3, 0.1, 0.0)), ("dolly", (0.0, 0.0, 1.0)), ("zoom", (0.0, 0.0, -1.0))]
    assert viewer.events.empty()  # an unknown verb is not queued
    _get(base + "set?key=learning_rate&value=0.01")
    _get(base + "set?material=2&key=albedo&value=0.1,0.2,0.3")
    assert viewer.drain_settings() == [{"key": "learning_rate", "value": "0.01", "material": None},
                                       {"key": "albedo", "value": "0.1,0.2,0.3", "material": 2}]
    for op in ("screenshot_png", "screenshot_hdr", "save_system", "reset_cache", "format_disk"):
        _get(base + "action?op=" + op)
    assert viewer.drain_actions() == ["screenshot_png", "screenshot_hdr", "save_system", "reset_cache"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(base + "nothing")
    assert err.value.code == 404


def test_apply_events_matches_jax(viewer):
    ref = JViewer(port=0)
    try:
        port_cam, ref_cam = Camera(**START), JCamera(**START)
        assert not apply_camera_events(port_cam, viewer.drain_events()) and not ref.apply_events(ref_cam)
        for q in ("op=orbit&dx=0.1&dy=-0.2", "op=dolly&d=1", "op=pan&dx=0.3&dy=0.1", "op=zoom&d=-1",
                  "op=dolly&d=-1", "op=orbit&dx=-0.4&dy=0.7", "op=zoom&d=1"):
            _get(viewer.url + "control?" + q)
            _get(ref.url + "control?" + q)
        assert apply_camera_events(port_cam, viewer.drain_events()) and ref.apply_events(ref_cam)
        assert _fields(port_cam) == _fields(ref_cam) != _fields(Camera(**START))
    finally:
        ref.close()


# ---------------------------------------------------------------------------
# the control panel against the JAX functions
# ---------------------------------------------------------------------------

SETTINGS = [
    {"key": "render_mode", "value": "NO_CACHE", "material": None},
    {"key": "learning_rate", "value": "0.005", "material": None},
    {"key": "train_unbiased_ratio", "value": "0.125", "material": None},
    {"key": "area_spread_factor", "value": "0.02", "material": None},
    {"key": "tm_gamma", "value": "2.4", "material": None},
    {"key": "tm_sat", "value": "0.8", "material": None},
    {"key": "albedo", "value": "0.2,0.4,0.6", "material": 1},
    {"key": "roughness", "value": "0.3", "material": 0},
    {"key": "ior", "value": "1.33", "material": 2},
    {"key": "thin_walled", "value": "1", "material": 3},
    {"key": "emission_intensity", "value": "5,4,3", "material": 0},
    {"key": "encoding", "value": "hash", "material": None},
    # bad edits: printed and dropped
    {"key": "render_mode", "value": "BOGUS", "material": None},
    {"key": "learning_rate", "value": "fast", "material": None},
    {"key": "albedo", "value": "x,y", "material": 0},
    {"key": "ior", "value": "1.5", "material": 99},
    {"key": "tm_nothing", "value": "1", "material": None},
]


@pytest.fixture(scope="module")
def renderers(tmp_path_factory):
    from nrc_tpu.config import RenderMode as JRenderMode
    from nrc_tpu.render.renderer import Renderer as JRenderer
    from nrc_tpu.scene.scene_builder import load_scene as jax_load_scene
    from nrc_tpu_torch.config import RenderMode
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.scene_builder import load_scene

    files = write_cornell_box_files(str(tmp_path_factory.mktemp("cornell")), (32, 32))
    port = Renderer(*load_scene(*files), render_mode=RenderMode.FULL, device="cpu")
    ref = JRenderer(*jax_load_scene(*files), render_mode=JRenderMode.FULL)
    return port, ref


def _panel(r):
    """What an edit can change, as plain values."""
    return (r.cfg.render_mode.name, r.net_cfg.encoding.name, float(r.hyper.learning_rate),
            float(r.hyper.train_unbiased_ratio), float(r.hyper.area_spread_factor), r.system.tonemapper.gamma,
            r.system.tonemapper.saturation, r.iteration)


def test_gui_params_and_settings_match_jax(renderers, capsys):
    port, ref = renderers
    assert cli._gui_params(port) == jcli._gui_params(ref)
    for s in SETTINGS:
        cli._apply_setting(port, dict(s))
        said_port = capsys.readouterr().out
        jcli._apply_setting(ref, dict(s))
        said_ref = capsys.readouterr().out
        assert said_port == said_ref, s
        assert _panel(port) == _panel(ref), s
        assert cli._gui_params(port) == jcli._gui_params(ref), s
    assert "ignoring bad setting" in said_port  # the last edit
    assert port.net_cfg.encoding.name == "HASH" and port.net_state.grid is not None


# ---------------------------------------------------------------------------
# the present loop, driven on the CPU
# ---------------------------------------------------------------------------

SPP = 2


def test_present_loop_serves_moves_and_writes(tmp_path, monkeypatch):
    files = write_cornell_box_files(str(tmp_path / "cornell"), (32, 32))
    made, published, seen = [], [], {}
    real_init, real_publish = Viewer.__init__, Viewer.publish

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    def publish(self, png, iteration, *a, **kw):
        real_publish(self, png, iteration, *a, **kw)
        published.append(iteration)

    renders = []
    real_restart = cli.Renderer.restart_accumulation

    def restart(self):
        renders.append("restart")
        real_restart(self)

    real_frame = cli.Renderer.render_frame

    def render_frame(self):
        seen["renderer"] = self
        renders.append("frame")
        return real_frame(self)

    def page(_seconds):
        """The loop's idle wait: act as a page does, one step a call."""
        v, r = made[0], seen["renderer"]
        if "png" not in seen:
            if published[-1] != SPP:
                return  # the accumulated frames are published within a second
            seen["png"] = _get(v.url + "frame.png")[2]
            seen["stats"] = json.loads(_get(v.url + "stats")[2])
            seen["want"] = tonemap_to_u8(torch.from_numpy(r.image_hdr().copy()), r.system.tonemapper).numpy()
            seen["phi"] = r.scene.camera.phi
            _get(v.url + "control?op=orbit&dx=0.1&dy=0.05")
        elif "orbited" not in seen:
            seen["orbited"] = r.scene.camera.phi
            _get(v.url + "action?op=screenshot_png")
        else:
            raise KeyboardInterrupt

    monkeypatch.setattr(Viewer, "__init__", init)
    monkeypatch.setattr(Viewer, "publish", publish)
    monkeypatch.setattr(cli.Renderer, "restart_accumulation", restart)
    monkeypatch.setattr(cli.Renderer, "render_frame", render_frame)
    monkeypatch.setattr(cli.time, "sleep", page)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["-s", files[0], "-d", files[1], "--device", "cpu", "--present", "--port", "0",
                         "--spp", str(SPP), "--output", str(tmp_path / "shot")]) == 0
    printed = out.getvalue()
    assert f"presenting at {made[0].url}" in printed
    assert np.array_equal(decode_png(seen["png"]), seen["want"]) and seen["want"].std() > 0
    assert seen["stats"]["iteration"] == SPP
    # the orbit moved the camera and restarted the accumulation, which then
    # rendered SPP frames again
    assert seen["orbited"] != seen["phi"]
    assert renders == ["frame"] * SPP + ["restart"] + ["frame"] * SPP
    # written by the action, then again by the CLI at its end
    shot = str(tmp_path / f"shot_{SPP}spp.png")
    assert printed.count(shot + "\n") == 2 and (tmp_path / f"shot_{SPP}spp.png").exists()
    with pytest.raises(urllib.error.URLError):
        _get(made[0].url)  # the server is closed
    write_png(str(tmp_path / "again.png"), decode_png(seen["png"]))
    assert (tmp_path / "again.png").read_bytes() == seen["png"]


def test_the_loops_renderer_goes_with_it(monkeypatch):
    """The present loop leaves nothing that holds its renderer: freed by
    reference counting once the loop has ended, with no collection (on the
    card a renderer left for one frees its graphs whenever a collection
    runs, which ends a capture that it falls in)."""
    from nrc_tpu_torch.render.renderer import Renderer
    from nrc_tpu_torch.scene.scene_builder import cornell_box

    def stop(_seconds):
        raise KeyboardInterrupt

    monkeypatch.setattr(cli.time, "sleep", stop)
    args = cli.build_parser().parse_args(["-s", "-", "-d", "-", "--present", "--port", "0", "--spp", "1"])
    r = Renderer(*cornell_box((16, 16)), train=False, device="cpu")
    collecting = gc.isenabled()
    gc.disable()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli._present_loop(args, r, 1, 0.0) == 1
        ref = weakref.ref(r)
        del r
        assert ref() is None
    finally:
        if collecting:
            gc.enable()
