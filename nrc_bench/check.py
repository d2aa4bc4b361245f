"""Whether the timed path is correct: the window's last frames against the
plain reference's, each from the same state before it.

The harness keeps, just before each of the window's last ``CHECKED``
frames, the program's network state, the frame counters, the camera, the
tile size and the image; after the frame, the image, the network state,
the frame's loss and record count. Once the window has closed, the peak
memory is read and the program is freed, the reference
(``nrc_bench/reference``) renders the same frame for every pixel, traces
the whole training wavefront and takes the four steps from the kept state.
The first kept frame whose training record count the reference's equals
is judged (``judge``): a frame whose training wavefront parted from the
reference's at a tie draws other batches, and its training is not
comparable. ``compare`` gives the numbers held to the cell's limits
(``limits/<cell>.json``):

- ``init_max_abs``: the program's network as first made from the seed
  against the reference's own init from the seed, largest difference;
- ``pixels_apart_ppm``: pixels whose value after the frame differs from
  the reference's by more than ``PIXEL_TOL`` of the frame's own radiance
  there plus its mean over the frame (times the accumulation weight), in
  parts per million of the frame's pixels;
- ``loss_gap``: the frame's mean training loss, relative gap;
- ``weights_gap``: over the trained leaves (the MLP's three weight
  tensors, and the hash table), the gap between the norms of the
  program's and the reference's change in the frame, over the larger of
  the reference's norm and the median leaf's; the median leaf.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, NamedTuple

import torch

PIXEL_TOL = 1e-3
CHECKED = 3
WEIGHT_KEYS = ("params.w_in", "params.w_hidden", "params.w_out")
GRID_KEYS = ("grid.table", "ema_grid.table", "opt.mu_grid", "opt.nu_grid")
MLP_KEYS = tuple(f"{p}.{w}" for p in ("params", "ema", "opt.mu", "opt.nu") for w in ("w_in", "w_hidden", "w_out"))


class Before(NamedTuple):
    state: Dict[str, torch.Tensor]
    image: torch.Tensor
    iteration: int
    total_subframe: int
    camera: dict
    tile_size: tuple
    learning_rate: float


class After(NamedTuple):
    state: Dict[str, torch.Tensor]
    image: torch.Tensor
    loss: torch.Tensor
    num_records: torch.Tensor


def state_dict(state) -> Dict[str, torch.Tensor]:
    """A port ``NetworkState`` -> copies of its tensors under the checkpoint
    keys (device copies; nothing is read back)."""
    out = {}
    for prefix, mlp in (("params", state.params), ("ema", state.ema), ("opt.mu", state.opt.mu),
                        ("opt.nu", state.opt.nu)):
        for w in ("w_in", "w_hidden", "w_out"):
            out[f"{prefix}.{w}"] = getattr(mlp, w).detach().clone()
    out["opt.step"] = state.opt.step.detach().clone()
    if state.grid is not None:
        for key, t in zip(GRID_KEYS, (state.grid.table, state.ema_grid.table, state.opt.mu_grid,
                                       state.opt.nu_grid)):
            out[key] = t.detach().clone()
    return out


def before(r, pixels: torch.Tensor) -> Before:
    cam = r.scene.camera
    return Before(state_dict(r.net_state), r.image[pixels].clone(), r.iteration, r.total_subframe,
                  dict(center=tuple(cam.center), phi=cam.phi, theta=cam.theta, fov=cam.fov,
                       distance=cam.distance),
                  tuple(r.cfg.tile_size), float(r.hyper.learning_rate))


def after(r, pixels: torch.Tensor, stats) -> After:
    return After(state_dict(r.net_state), r.image[pixels].clone(), stats.loss.detach().clone(),
                 stats.num_train_records.detach().clone())


def reference_frame(data, network: dict, b: Before, pixels: torch.Tensor, device, operands: str = "bf16",
                    patch=None):
    """The reference's frame from ``b``: (SampledFrame, state after as a
    key -> tensor dict). ``patch`` maps the reference's network module to a
    replacement ``train_frame`` (the faults of the calibration)."""
    from .reference import config as RC
    from .reference.models import network as RN
    from .reference.render import frame as RF
    from .reference.render.scene_device import scene_flags, upload_scene
    from .reference.scene.build import reference_scene
    from .system import network_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = reference_scene(data, camera=b.camera)
    ds = upload_scene(scene, device)
    w, h = data.system["resolution"]
    lo, hi = scene.aabb()
    system = RC.SystemConfig()
    cfg = RC.FrameConfig(
        width=w, height=h, tile_size=b.tile_size, max_depth=data.system["path_lengths"][1],
        min_depth_rr=data.system["path_lengths"][0], render_mode=RC.RenderMode.FULL, train=True,
        lens_shader=scene.lens_shader, scene_epsilon=system.scene_epsilon,
        position_scale=0.1 / max(float((hi - lo).max()), 1e-6), **scene_flags(scene),
    )
    net_cfg = network_config(RC, network)
    net_cfg.operands = operands
    state = RN.state_from_numpy({k: v.detach().cpu().numpy() for k, v in b.state.items()}, device)
    cam = RF.CameraArrays(*(torch.from_numpy(x).to(device) for x in scene.camera.frustum()))
    original = RN.train_frame
    if patch is not None:
        RN.train_frame = patch(original)
    try:
        res = RF.sampled_frame(ds, state, b.image, pixels, cam, b.iteration, b.total_subframe, cfg, net_cfg,
                               b.learning_rate)
    finally:
        RN.train_frame = original
    out = {k: v for k, v in zip(MLP_KEYS, RN.state_tensors(state))}
    if state.grid is not None:
        out.update(zip(GRID_KEYS, (state.grid.table, state.ema_grid.table, state.opt.mu_grid, state.opt.nu_grid)))
    return res, out


def reference_init(network: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    from .reference import config as RC
    from .reference.models import network as RN
    from .system import network_config

    state = RN.init_network(torch.Generator().manual_seed(seed), network_config(RC, network), device)
    out = dict(zip(MLP_KEYS, RN.state_tensors(state)))
    if state.grid is not None:
        out.update(zip(GRID_KEYS, (state.grid.table, state.ema_grid.table, state.opt.mu_grid, state.opt.nu_grid)))
    return out


def init_max_abs(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> float:
    return max(float((program[k].to(v.device) - v.detach()).abs().max()) for k, v in reference.items())


def pixels_apart_ppm(image, reference) -> float:
    """Pixels apart from the reference frame ``reference`` by more than
    ``PIXEL_TOL`` of the frame's own radiance there plus its mean over the
    frame (times the accumulation weight), in parts per million of the
    pixels compared; a value that is not finite is apart."""
    own = reference.contrib.abs().amax(dim=-1)
    scale = reference.weight * (own + float(own.mean())) + 1e-30
    gap = (image - reference.image).abs().amax(dim=-1) / scale
    return 1e6 * int((~(gap <= PIXEL_TOL)).sum()) / gap.shape[0]


def weights_gap(b: Before, program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor]) -> float:
    """The median over the trained leaves of |norm of the program's change -
    norm of the reference's| / max(norm of the reference's, the median of
    those norms); not finite reads infinite."""
    keys = [k for k in WEIGHT_KEYS + GRID_KEYS[:1] if k in reference]
    p = {k: float((program[k].detach() - b.state[k]).norm()) for k in keys}
    r = {k: float((reference[k].detach() - b.state[k]).norm()) for k in keys}
    median = statistics.median(r.values())
    gaps = [abs(p[k] - r[k]) / max(r[k], median, 1e-30) for k in keys]
    return statistics.median(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def compare(b: Before, program: After, frame, reference: Dict[str, torch.Tensor]) -> dict:
    """The frame's numbers: ``program`` (the program's, or a control's)
    against the reference frame ``frame`` and its state ``reference``."""
    loss_r = float(frame.losses.mean())
    loss_gap = abs(float(program.loss) - loss_r) / max(abs(loss_r), 1e-30)
    return {
        "pixels_apart_ppm": pixels_apart_ppm(program.image, frame),
        "loss_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
        "weights_gap": weights_gap(b, program.state, reference),
        "records": int(program.num_records),
        "records_reference": int(frame.num_records),
    }


def judge(data, network: dict, frames, pixels: torch.Tensor, device, **reference_kw):
    """The first of the window's last frames ``frames`` [(Before, After)]
    whose record count the reference's equals, or else the last: (index,
    its numbers, the reference frame and state)."""
    for k, (b, a) in enumerate(frames):
        frame, ref = reference_frame(data, network, b, pixels, device, **reference_kw)
        numbers = compare(b, a, frame, ref)
        if numbers["records"] == numbers["records_reference"] or k == len(frames) - 1:
            return k, numbers, frame, ref


def as_after(frame, state: Dict[str, torch.Tensor]) -> After:
    """A reference frame in the program's place (the control)."""
    return After(state, frame.image, frame.losses.mean(), frame.num_records)
