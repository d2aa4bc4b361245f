"""The port's ``Renderer`` API beyond the frame: live material edits,
screenshots and image files, the system description and the render-state
checkpoint, on the CPU and against the JAX package where it has the same.

- ``update_material`` must leave the renderer in the state of a fresh
  renderer built on the edited scene: the next frame bit for bit, and the
  material and light tables copied into the tensors a captured frame reads
  (the same storage before and after).
- ``utils/image_io.py`` is the JAX package's copy: the same bytes from the
  same pixels (PNG and HDR).
- A render state written by either package loads in the other: weights,
  EMA, moments, step, image, counters and tile size equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.models import checkpoint as JC
from nrc_tpu.render.renderer import Renderer as JRenderer
from nrc_tpu.utils import image_io as JI
from nrc_tpu.utils.tonemap import tonemap_to_u8 as jax_tonemap_to_u8
from nrc_tpu_torch.config import InputEncoding, NetworkConfig, RenderMode
from nrc_tpu_torch.models import checkpoint as PC
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.render.renderer import Renderer
from nrc_tpu_torch.scene.materials import Archetype, MaterialTable
from nrc_tpu_torch.scene.scene_builder import cornell_box, cornell_glass
from nrc_tpu_torch.utils import image_io as PI
from nrc_tpu_torch.utils.tonemap import tonemap_to_u8
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_scene import jax_cornell_scene

RES = (32, 32)


def _small(builder=cornell_box, tiles=(8, 8)):
    scene, system = builder(RES)
    return scene, dataclasses.replace(system, tile_size=tiles)


def _bits(r):
    st = r.net_state
    return [t.view(torch.int32) for t in N.state_tensors(st)] + [st.opt.step, r.image.view(torch.int32)]


@pytest.mark.parametrize("index, change", [
    (0, dict(albedo=(0.2, 0.6, 0.9))),
    (0, dict(archetype=Archetype.SPECULAR_REFLECT_TRANSMIT, ior=1.33)),
    (3, dict(emission_intensity=(40.0, 30.0, 20.0))),  # the ceiling light
], ids=["albedo", "to_glass", "light"])
def test_update_material_equals_a_fresh_renderer(index, change):
    """Edit one material of a renderer that has rendered a frame, then one
    FULL + train frame: the same bits as a fresh renderer on the edited
    scene from the same state and counters; the tables are the old tensors
    with the new values."""
    scene, system = _small()
    r = Renderer(scene, system, adaptive_tiles=False, device="cpu")
    r.render_frame()
    tables = [r.device_scene.mat_row, r.device_scene.lights.light_row]
    ptrs = [t.data_ptr() for t in tables]
    r.update_material(index, **change)
    assert [t.data_ptr() for t in (r.device_scene.mat_row, r.device_scene.lights.light_row)] == ptrs
    assert r.iteration == 0 and not r.image.any()

    edited, _ = _small()
    edited.material_rows[index] = dataclasses.replace(edited.material_rows[index], **change)
    edited.materials = MaterialTable.build(edited.material_rows)
    assert scene.material_rows[index] == edited.material_rows[index]
    fresh = Renderer(edited, system, adaptive_tiles=False, device="cpu")
    fresh.net_state = r.net_state
    fresh.total_subframe = r.total_subframe
    assert fresh.cfg == r.cfg
    assert torch.equal(fresh.device_scene.mat_row, r.device_scene.mat_row)
    assert torch.equal(fresh.device_scene.lights.light_row, r.device_scene.lights.light_row)
    for x in (r, fresh):
        x.render_frame()
    assert all(torch.equal(a, b) for a, b in zip(_bits(r), _bits(fresh)))


def test_update_material_to_an_unported_archetype_raises():
    scene, system = _small()
    r = Renderer(scene, system, device="cpu")
    with pytest.raises(NotImplementedError):
        r.update_material(0, archetype=Archetype.HAIR)


def test_image_files_are_the_jax_packages_bytes(tmp_path):
    rs = np.random.default_rng(0)
    ldr = rs.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    hdr = (rs.random((17, 23, 3)) * 40.0).astype(np.float32)
    hdr[0, 0] = 0.0
    for name, write, arg in (("png", "write_png", ldr), ("hdr", "write_hdr", hdr)):
        a, b = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
        getattr(PI, write)(str(a), arg)
        getattr(JI, write)(str(b), arg)
        assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(PI.read_png(str(tmp_path / "port.png")), ldr)
    back = PI.read_hdr(str(tmp_path / "port.hdr"))
    assert np.array_equal(back, JI.read_hdr(str(tmp_path / "jax.hdr")))
    assert np.abs(back - hdr).max() <= hdr.max() / 128  # 8 mantissa bits


def test_screenshots(tmp_path):
    """The tonemapped PNG holds ``tonemap_to_u8`` of ``image_hdr`` (and the
    JAX tone curve's to within one level: the two round pow apart); the
    ``.hdr`` the linear image; the time view's PNG its clamped colours."""
    scene, system = _small()
    r = Renderer(scene, system, render_mode=RenderMode.NO_CACHE, train=False, device="cpu")
    r.render(2)
    png = r.screenshot(str(tmp_path / "shot"))
    assert png.endswith("shot.png")
    img = PI.read_png(png)
    hdr = r.image_hdr()
    assert np.array_equal(img, tonemap_to_u8(torch.from_numpy(hdr.copy()), system.tonemapper).numpy())
    ref = np.asarray(jax_tonemap_to_u8(jnp.asarray(hdr), system.tonemapper))
    assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1 and img.std() > 0
    path = r.screenshot(str(tmp_path / "shot"), tonemap=False)
    assert path.endswith(".hdr") and np.abs(PI.read_hdr(path) - hdr).max() <= hdr.max() / 128
    r.set_render_mode(RenderMode.DEBUG_TIME_VIEW)
    r.render(1)
    tv = PI.read_png(r.screenshot(str(tmp_path / "tv.png")))
    assert np.array_equal(tv, (np.clip(r.image_hdr(), 0.0, 1.0) * 255.0).astype(np.uint8))


def test_system_description_is_the_jax_packages(tmp_path):
    scene, system = _small(cornell_glass)
    jscene = jax_cornell_scene(RES)
    text = {name: open(r.save_system_description(str(tmp_path / name))).read()
            for name, r in (("port", Renderer(scene, system, device="cpu")), ("jax", JRenderer(jscene, system)))}
    assert text["port"] == text["jax"] and "camera 0.750781 0.5 55.0 20.0" in text["port"]


def _jax_state_numpy(jr):
    return {k: np.asarray(v) for k, v in JC._flatten(jr.net_state).items()}


def test_render_state_crosses_packages(tmp_path):
    """A render state written by the JAX renderer loads into the port's and
    the other way round: state, image, counters and tile size equal."""
    scene, system = _small()
    jr = JRenderer(jax_cornell_scene(RES), system, render_mode=RenderMode.FULL, train=False)
    jr.render_frame()
    jr.render_frame()
    jpath = JC.save_render_state(str(tmp_path / "jax_state"), jr)
    assert PC.is_render_state(jpath)

    pr = Renderer(scene, dataclasses.replace(system, tile_size=(16, 16)), render_mode=RenderMode.FULL,
                  train=False, device="cpu")
    bound = pr.net_state
    PC.load_render_state(jpath, pr)
    assert pr.net_state is bound  # copied into the tensors a graph reads
    got = N.state_to_numpy(pr.net_state)
    for k, v in _jax_state_numpy(jr).items():
        assert np.array_equal(got[k], v), k
    assert np.array_equal(pr.image.numpy(), np.asarray(jr.image))
    assert (pr.iteration, pr.total_subframe, pr.cfg.tile_size) == (2, 2, (8, 8))

    pr.render_frame()
    ppath = PC.save_render_state(str(tmp_path / "port_state.npz"), pr)
    jr2 = JRenderer(jax_cornell_scene(RES), dataclasses.replace(system, tile_size=(4, 4)), train=False)
    JC.load_render_state(ppath, jr2)
    want = N.state_to_numpy(pr.net_state)
    for k, v in _jax_state_numpy(jr2).items():
        assert np.array_equal(v, want[k]), k
    assert np.array_equal(np.asarray(jr2.image), pr.image.numpy())
    assert (jr2.iteration, jr2.total_subframe, jr2.cfg.tile_size) == (3, 3, (8, 8))


def test_render_state_of_another_encoding_is_bound(tmp_path):
    """A state of other shapes (the hash encoding's) cannot be copied into
    the bound one: it is bound instead, and the graphs are dropped."""
    scene, system = _small()
    h = Renderer(scene, system, net_cfg=NetworkConfig(encoding=InputEncoding.HASH), device="cpu")
    path = PC.save_render_state(str(tmp_path / "hash"), h)
    r = Renderer(scene, system, device="cpu")
    r.graphs["stale"] = None
    bound = r.net_state
    PC.load_render_state(path, r)
    assert r.net_state is not bound and r.net_state.grid is not None and not r.graphs
    assert torch.equal(r.net_state.grid.table, h.net_state.grid.table)
    with pytest.raises(ValueError):  # an image of another resolution
        PC.load_render_state(path, Renderer(*cornell_box((16, 16)), device="cpu"))
    assert not PC.is_render_state(PC.save_checkpoint(str(tmp_path / "net"), r.net_state))
