"""Network checkpoints as one portable ``.npz`` file.

Port of the npz half of ``nrc_tpu/models/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``): the whole trainable state (weights, EMA weights, Adam
moments and step, and with the hash encoding the table, its EMA and its
moments) under the JAX package's keys (``"params.w_in"``, ...,
``"opt.step"``, ``"grid.table"``, ``"ema_grid.table"``, ``"opt.mu_grid"``,
``"opt.nu_grid"``), so that a file written by either package is read by the
other; and the render-state checkpoint over it (``nrc_tpu/models/
checkpoint.py:117-185``): the network under ``"net."`` + those keys, the
accumulated image, the iteration and subframe counters and the tile size
under ``"render.*"``, the same file in both packages. Loading one writes
into the renderer's tensors in place, so a captured frame goes on reading
them (a state of another encoding is bound instead, ``Renderer.bind_state``,
and the graphs are dropped).

A level-sharded ``ParallelRenderer`` (``parallel/shard.py``) holds one
block of the hash table's levels on each rank; its files hold the whole
table all the same, as the JAX package's do: saving gathers every rank's
block (``ParallelRenderer.net_state_arrays``, a collective that every rank
calls; rank 0 writes), and loading cuts a whole table to the rank's block
(``Renderer.state_block``) and refuses a file whose table is not whole.
Such a renderer saves its network whole in a render state: a rank's
``net_state`` holds its block only.
The orbax container is not ported: it is written through orbax and
tensorstore, which the port does not use.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import InputEncoding, NetworkConfig
from .network import GRID_KEYS, NetworkState, state_from_numpy, state_to_numpy


def save_checkpoint(path: str, state: NetworkState) -> str:
    """Write ``state`` to ``path`` (``.npz`` appended when missing); returns
    the path written."""
    if not path.endswith(".npz"):
        path += ".npz"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **state_to_numpy(state))
    return path


def state_for_block(arrays: Mapping, cfg: NetworkConfig, device: Optional[torch.device] = None,
                    level_block: Optional[slice] = None) -> NetworkState:
    """The network state under the checkpoint keys of ``arrays``, for a
    renderer that holds the levels ``level_block`` of the hash table (None:
    all of them). A block is cut from whole tables only: a table of other
    than ``cfg.hash_n_levels`` levels (one rank's block, written before the
    files held whole tables) is refused, since nothing in it says which
    levels it holds."""
    if level_block is not None:
        for key in GRID_KEYS:
            if key in arrays and np.shape(arrays[key])[0] != cfg.hash_n_levels:
                raise ValueError(
                    f"the file's {key} holds {np.shape(arrays[key])[0]} of the {cfg.hash_n_levels} levels: "
                    f"a level-sharded renderer loads whole tables only"
                )
    return state_from_numpy(arrays, device, level_block=level_block)


def load_checkpoint(path: str, cfg: Optional[NetworkConfig] = None,
                    device: Optional[torch.device] = None, level_block: Optional[slice] = None) -> NetworkState:
    """Read a checkpoint onto ``device`` (default CPU). With ``cfg`` the
    file's encoding must be the config's. ``level_block`` (with ``cfg``)
    cuts a whole table to those levels: a level-sharded renderer's
    ``state_block``."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    has_grid = "grid.table" in arrays
    if cfg is not None and (cfg.encoding == InputEncoding.HASH) != has_grid:
        raise ValueError(
            f"checkpoint encoding mismatch: file has_grid={has_grid}, config wants "
            f"{'hash' if cfg.encoding == InputEncoding.HASH else 'frequency'}"
        )
    return state_for_block(arrays, cfg, device, level_block)


def save_render_state(path: str, renderer) -> str:
    """Checkpoint a ``Renderer``: network state, accumulated image [H*W, 3],
    iteration and subframe counters and tile size, written to a temporary
    file and moved into place (a crash mid-save leaves the old file).

    A collective on a level-sharded ``ParallelRenderer``: every rank calls
    it (the table's blocks are gathered), and rank 0 alone writes; every
    rank returns the path."""
    arrays = {f"net.{k}": v for k, v in renderer.net_state_arrays().items()}
    arrays["render.image"] = renderer.image.detach().cpu().numpy()
    arrays["render.iteration"] = np.int64(renderer.iteration)
    arrays["render.total_subframe"] = np.int64(renderer.total_subframe)
    arrays["render.tile_size"] = np.asarray(renderer.cfg.tile_size, np.int32)
    if not path.endswith(".npz"):
        path += ".npz"
    if not renderer.lead:
        return path
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_render_state(path: str, renderer) -> None:
    """Restore a ``Renderer`` from a render state of either package: the
    network copied into its state (or bound with its graphs dropped, where
    the file's state has other shapes), the image copied into its image,
    the counters set and the tile size taken. A level-sharded
    ``ParallelRenderer`` takes its block of a whole table
    (``state_for_block``) from a file of any world size or package."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    image = torch.from_numpy(arrays["render.image"]).to(torch.float32)
    if tuple(image.shape) != tuple(renderer.image.shape):
        raise ValueError(f"render state image {tuple(image.shape)}, the renderer's is {tuple(renderer.image.shape)}")
    net = {k[len("net."):]: v for k, v in arrays.items() if k.startswith("net.")}
    state = state_for_block(net, renderer.net_cfg, renderer.device, renderer.state_block)
    try:
        renderer.net_state = state  # copied into the tensors the graphs read
    except ValueError:  # other shapes: another encoding
        renderer.bind_state(state)
    renderer.image.copy_(image)
    renderer.iteration = int(arrays["render.iteration"])
    renderer.total_subframe = int(arrays["render.total_subframe"])
    ts = tuple(int(x) for x in arrays["render.tile_size"])
    if ts != renderer.cfg.tile_size:
        renderer.cfg = dataclasses.replace(renderer.cfg, tile_size=ts)


def is_render_state(path: str) -> bool:
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        return "render.image" in z.files
