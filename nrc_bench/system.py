"""The system under test: the port's renderer, made from the benchmark's data.

Everything the harness takes from the program goes through here: the
scene and system objects built from a ``SceneData`` with the program's own
material, light and camera types, and the ``Renderer`` of a configuration,
its network made from the run's seed on the device it renders on.
"""

from __future__ import annotations

import torch

from .scenes import TRIANGLE_FIELDS, SceneData

# the NetworkConfig fields a configuration file states (``"network"``)
NETWORK_FIELDS = (
    "encoding", "n_neurons", "n_hidden_layers", "ema_decay", "adam_l2_reg", "adam_beta1", "adam_beta2",
    "adam_eps", "freq_n_frequencies", "oneblob_n_bins", "freq_domain_scale", "hash_n_levels",
    "hash_n_features_per_level", "hash_log2_size", "hash_base_resolution", "hash_per_level_scale",
)


def network_config(module, network: dict):
    """``module.NetworkConfig`` (the port's or the reference's) of a
    configuration's ``"network"``: the encoding by name, the rest as
    numbers."""
    fields = {k: v for k, v in network.items() if k in NETWORK_FIELDS}
    fields["encoding"] = module.InputEncoding[fields["encoding"].upper()]
    return module.NetworkConfig(**fields)


def port_scene(data: SceneData):
    """(Scene, SystemConfig) of the port from ``data``."""
    from nrc_tpu_torch.config import SystemConfig
    from nrc_tpu_torch.scene.camera import Camera
    from nrc_tpu_torch.scene.materials import Archetype, EmissionMode, Material, MaterialTable
    from nrc_tpu_torch.scene.scene_builder import Scene, build_lights

    rows = []
    for m in data.materials:
        f = dict(m)
        if "archetype" in f:
            f["archetype"] = Archetype[f["archetype"]]
        if "emission_mode" in f:
            f["emission_mode"] = EmissionMode[f["emission_mode"]]
        rows.append(Material(**f))
    tri = data.triangles
    lights, light_id = build_lights((), (), rows, *(tri[k] for k in TRIANGLE_FIELDS), tri["material_id"])
    w, h = data.system["resolution"]
    cam = data.camera
    scene = Scene(**{k: tri[k] for k in TRIANGLE_FIELDS}, material_id=tri["material_id"], light_id=light_id,
                  materials=MaterialTable.build(rows), material_rows=rows, lights=lights,
                  camera=Camera(aspect=w / max(h, 1), **cam))
    system = SystemConfig(
        resolution=(w, h), tile_size=tuple(data.system["tile_size"]), samples_sqrt=1,
        path_lengths=tuple(data.system["path_lengths"]), center=tuple(cam["center"]),
        camera=(cam["phi"], cam["theta"], cam["fov"], cam["distance"]),
    )
    return scene, system


def make_renderer(data: SceneData, network: dict, device: torch.device, seed: int):
    """The port's ``Renderer`` for FULL + train on ``device`` with the
    configuration's network, its weights drawn from ``seed``."""
    from nrc_tpu_torch import config as C
    from nrc_tpu_torch.render.renderer import Renderer

    scene, system = port_scene(data)
    r = Renderer(scene, system, net_cfg=network_config(C, network), render_mode=C.RenderMode.FULL, train=True,
                 device=device)
    r.reset_cache(seed)
    return r


def training_constants() -> dict:
    """The program's records a frame and batches, to hold a configuration to."""
    from nrc_tpu_torch import config as C

    return {"records_per_frame": C.NUM_TRAINING_RECORDS_PER_FRAME, "batches": C.NUM_BATCHES,
            "batch_size": C.BATCH_SIZE}


def tuner_tiles() -> list:
    """Every tile side the program's tuner (``adjust_tile_size``) can choose:
    its answers from any side up to 128 for record counts 0 to 2**24. It
    reads a count two frames late, after other sides, so any of them can
    follow any other."""
    from nrc_tpu_torch.config import adjust_tile_size

    counts = (0,) + tuple(1 << k for k in range(25))
    return sorted({adjust_tile_size((t, t), n)[0] for t in range(1, 129) for n in counts})
