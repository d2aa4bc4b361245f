"""Network checkpoints as one portable ``.npz`` file.

Port of the npz half of ``nrc_tpu/models/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``): the whole trainable state (weights, EMA weights, Adam
moments and step, and with the hash encoding the table, its EMA and its
moments) under the JAX package's keys (``"params.w_in"``, ...,
``"opt.step"``, ``"grid.table"``, ``"ema_grid.table"``, ``"opt.mu_grid"``,
``"opt.nu_grid"``), so that a file written by either package is read by the
other. The orbax container and the render-state checkpoint are not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import InputEncoding, NetworkConfig
from .network import NetworkState, state_from_numpy, state_to_numpy


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


def load_checkpoint(path: str, cfg: Optional[NetworkConfig] = None,
                    device: Optional[torch.device] = None) -> NetworkState:
    """Read a checkpoint onto ``device`` (default CPU). With ``cfg`` the
    file's encoding must be the config's."""
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
    return state_from_numpy(arrays, device)
