"""Configuration: render modes, encodings, NRC constants, system configs.

A copy of ``nrc_tpu/config.py`` (pure Python, no device code), so
that the port never imports the JAX package:
- enums + constants: ``nrc/shaders/neural_radiance_caching.h:14-54``
- system-description options: ``nrc/src/Application.cpp:1093-1293``
- per-frame system data: ``nrc/shaders/system_data.h`` (SystemDataPerFrame)
- compile-time switches: ``nrc/shaders/config.h``

The ``FrameConfig`` keeps the switches of the benchmark's scenes; the
port's switches for textures, cutouts, media, layered, measured and noise
materials and the tonemapper's settings are not copied.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple


class RenderMode(enum.IntEnum):
    """Render modes (reference ``neural_radiance_caching.h:14-22``)."""

    FULL = 0                # path trace + cache radiance at path end
    NO_CACHE = 1            # pure path tracing (unbiased oracle; no truncation)
    CACHE_ONLY = 2          # only the cache radiance, modulated by throughput
    CACHE_FIRST_VERTEX = 3  # visualize cache at first non-specular vertex
    DEBUG_CACHE_NO_THROUGHPUT_MODULATION = 4
    DEBUG_THROUGHPUT_ONLY = 5
    # TPU-native extension: per-pixel bounce-count heat map through the
    # reference's cold-to-hot color ramp — the deterministic analog of the
    # per-pixel clock() view (USE_TIME_VIEW, config.h:61-68 +
    # Rasterizer.cpp:306-345; clocks don't exist per lane on a TPU)
    DEBUG_TIME_VIEW = 6


class InputEncoding(enum.IntEnum):
    """Network input encodings (reference ``neural_radiance_caching.h:24-27``)."""

    FREQUENCY = 0
    HASH = 1


# --- NRC constants (reference neural_radiance_caching.h:29-45) ---------------
NUM_BATCHES = 4
NUM_TRAINING_RECORDS_PER_FRAME = 65536
BATCH_SIZE = NUM_TRAINING_RECORDS_PER_FRAME // NUM_BATCHES  # 16384
TRAIN_UNBIASED_RATIO = 1.0 / 16.0

# Compact radiance query: pos(3) + dir(2) + normal(2) + roughness(2)
# + diffuse(3) + specular(3)   (reference neural_radiance_caching.h:33-35)
NN_INPUT_DIMS = 15
NN_OUTPUT_DIMS = 3


def train_lr(encoding: InputEncoding) -> float:
    """Per-encoding learning rate.

    HASH keeps the reference literal (1e-2,
    ``neural_radiance_caching.h:47-54``). FREQUENCY deviates deliberately:
    the reference's 1e-3 measured 25.2 dB at the shipped 320^2 x 256 spp
    Cornell config on TPU, below the >=28 dB gate; 3e-3 (paired with EMA
    0.95, see ``default_ema_decay``) measures 28.42 dB — the full A/B
    (domain scale, warmup, EMA, reflectance factoring, 12 variants) is in
    BASELINE.md / ``tools/quality_ab.py``. The reference value remains one
    ``--lr 1e-3`` away.
    """
    if encoding == InputEncoding.FREQUENCY:
        return 3e-3
    if encoding == InputEncoding.HASH:
        return 1e-2
    return 1e-4


def default_ema_decay(encoding: InputEncoding) -> float:
    """Per-encoding EMA decay: HASH keeps tcnn's 0.99; FREQUENCY uses 0.95
    (the 256-spp Cornell A/B winner together with lr 3e-3 — a shorter EMA
    horizon tracks the faster-moving frequency-MLP weights; measured
    +3.2 dB over the 0.99/1e-3 reference pairing, BASELINE.md)."""
    return 0.99 if encoding == InputEncoding.HASH else 0.95


@dataclasses.dataclass
class NRCHyperParams:
    """Tunable NRC hyper-parameters (reference ``Device.h:323-341`` DeviceState).

    ``area_spread_factor`` is the paper's {c} in Eq. 4; the reference inits it
    at 0.01 (``Application.cpp:73``) and passes sqrt(c) to the device.
    """

    learning_rate: float = train_lr(InputEncoding.FREQUENCY)
    train_unbiased_ratio: float = TRAIN_UNBIASED_RATIO
    area_spread_factor: float = 0.01

    @property
    def area_spread_factor_sqrt(self) -> float:
        return math.sqrt(self.area_spread_factor)


@dataclasses.dataclass
class NetworkConfig:
    """Model config literals (reference ``NRCNetworkConfigs.h:11-136``)."""

    encoding: InputEncoding = InputEncoding.FREQUENCY
    n_neurons: int = 64
    n_hidden_layers: int = 5
    # loss RelativeL2Luminance, optimizer EMA over Adam; None resolves
    # per encoding in __post_init__ (hash 0.99 = tcnn literal; frequency
    # 0.95, the measured A/B winner — see default_ema_decay)
    ema_decay: float = None
    adam_l2_reg: float = 1e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    # tcnn defaults eps 1e-8; hash config overrides to 1e-15
    adam_eps: float = 1e-8
    # frequency encoding: TriangleWave(3 dims, 12 freqs) + OneBlob(6, 4 bins)
    # + Identity(6)
    freq_n_frequencies: int = 12
    oneblob_n_bins: int = 4
    # TriangleWave input-domain scale. Queries arrive with positions
    # normalized to a ~0.1-unit span (FrameConfig.position_scale =
    # 0.1/extent); at scale 1.0 the first ~4 octaves of tri_j(x * 2^j) are
    # then nearly linear and carry no signal. The reference feeds the
    # MDL-state position scaled by 0.005 (hit.cu:595-597), which spans
    # ~2.75 units on its Cornell — domain scale 32 reproduces that octave
    # coverage (0.1 * 32 = 3.2). A/B'd in BASELINE.md (tools/quality_ab.py);
    # default stays 1.0 until the TPU A/B confirms the winner.
    freq_domain_scale: float = 1.0
    # hash encoding: 16 levels, 2 features/level, 2^15 table, base res 16, x2
    hash_n_levels: int = 16
    hash_n_features_per_level: int = 2
    hash_log2_size: int = 15
    hash_base_resolution: int = 16
    hash_per_level_scale: float = 2.0
    # P6 (SURVEY §2.5): shard the hash tables over this mesh axis. None =
    # replicated (single chip / small tables). When set, each chip owns
    # L/D whole resolution LEVELS of the [L, S, F] table; a lookup
    # all_gathers the query positions, each chip gathers features of its
    # own levels for all D*B queries (dense unmasked gathers, O(B*8*L)
    # global work), and one all_to_all transposes completed features back
    # (owner-routed: no partial sums). Autodiff derives the distributed
    # gradient exchange from the adjoint collectives. Enables tables far
    # beyond one chip's HBM (``ops/encodings.py::sharded_hash_grid_lookup``).
    hash_shard_axis: str = None
    # the MLP's operand rounding (ops/mlp.py::ROUNDING): "bf16" as configured,
    # "fp8" for the benchmark's control
    operands: str = "bf16"

    @property
    def learning_rate(self) -> float:
        return train_lr(self.encoding)

    def __post_init__(self) -> None:
        if self.encoding == InputEncoding.HASH:
            self.adam_eps = 1e-15
        if self.ema_decay is None:
            self.ema_decay = default_ema_decay(self.encoding)


@dataclasses.dataclass
class SystemConfig:
    """System-description options (reference ``Application.cpp:1093-1293``).

    Loaded from the same key-value text format as the reference's
    ``data/system_*.txt`` files, so those files work directly.
    """

    devices_mask: int = 1
    arena_size_mib: int = 64
    interop: int = 0
    present: int = 0
    peer_to_peer: int = 0
    resolution: Tuple[int, int] = (1280, 720)
    tile_size: Tuple[int, int] = (8, 8)
    samples_sqrt: int = 1
    path_lengths: Tuple[int, int] = (2, 6)   # (min before RR, max)
    walk_length: int = 2
    epsilon_factor: float = 500.0            # scene epsilon = factor * 1e-7
    clock_factor: float = 1000.0
    lens_shader: int = 0                     # 0 pinhole, 1 fisheye, 2 sphere
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera: Tuple[float, float, float, float] = (0.75, 0.5, 60.0, 1.0)
    prefix_screenshot: str = "./nrc_tpu"
    search_paths: Tuple[str, ...] = ()

    @property
    def scene_epsilon(self) -> float:
        return self.epsilon_factor * 1.0e-7


@dataclasses.dataclass
class FrameConfig:
    """Static shape/branch configuration of the jitted frame program.

    The reference adapts tile size continuously (``Device::adjustTileSize``,
    ``Device.cpp:818-828``); we quantize tile sizes to powers of two so the
    jit cache holds a handful of programs instead of recompiling every frame.
    ``max_train_suffix_records`` replaces the global 65536-capacity atomic
    record allocator with a per-tile strided layout: each training path owns
    a fixed number of record slots (its records are consecutive, so radiance
    propagation is a dense reverse scan instead of a linked-list walk —
    reference ``nrc_helpers.cu:131-224``).
    """

    width: int = 320
    height: int = 320
    tile_size: Tuple[int, int] = (16, 16)
    max_depth: int = 6
    min_depth_rr: int = 2
    max_train_records_per_ray: int = 8
    render_mode: RenderMode = RenderMode.FULL
    train: bool = True
    lens_shader: int = 0
    scene_epsilon: float = 1e-4
    direct_lighting: bool = True
    # sqrt of the paper's area-spread constant {c} (Eq. 4); live-tunable
    # via NRCHyperParams (nrcAreaSpreadFactorSqrt, system_data.h:139)
    area_spread_sqrt: float = 0.1
    # fraction of training rays traced unbiased (TRAIN_UNBIASED_RATIO)
    train_unbiased_ratio: float = 1.0 / 16.0
    # Reflectance factorization (the paper's albedo factoring; the
    # reference's USE_REFLECTANCE_FACTORING compile switch, config.h:115-118,
    # shipped default-off with an inconsistent in-trace path): the network
    # learns radiance / (diffuse+specular albedo) and predictions are
    # multiplied back by the query's reflectance at every consumption site.
    reflectance_factoring: bool = False
    # Static set of BSDF archetypes present in the scene (None = all):
    # specializes the compiled lobe families, the analog of the reference
    # JIT-compiling only declared MDL materials (Raytracer.cpp:1968-2163).
    archetype_set: object = None  # Optional[frozenset[int]]
    # Per-scene position normalization applied to radiance-query positions.
    # The reference hardcodes 0.005 for Cornell (``hit.cu:595-597``).
    position_scale: float = 0.005
    # NEE shadow-ray Russian roulette threshold (TPU-native deviation; the
    # reference traces every valid NEE sample, ``hit.cu:398-417``). A
    # sample whose UNOCCLUDED contribution luminance is below this value
    # survives with p = lum/tau (floored at 0.05) and is scaled by 1/p —
    # an unbiased estimator, same family as path Russian roulette. Culled
    # lanes get an empty t-range and pool into dead traversal chunks that
    # exit immediately (``ops/intersect.py::_coherence_key``), so the
    # occlusion walk's cost tracks the SURVIVING ray count. 0 disables
    # (trace-exact reference behavior); the RR uniform comes from a side
    # stream, so the main per-lane sample streams are identical either way.
    nee_rr_tau: float = 0.0

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def num_tiles_xy(self) -> Tuple[int, int]:
        return (self.width // self.tile_size[0], self.height // self.tile_size[1])

    @property
    def num_tiles(self) -> int:
        nx, ny = self.num_tiles_xy
        return nx * ny


def adjust_tile_size(tile_size: Tuple[int, int], num_train_records: int) -> Tuple[int, int]:
    """Adaptive tile sizing, quantized to powers of two.

    Mirrors the reference's per-frame rescale by sqrt(1.25 * n / 65536)
    (``Device.cpp:818-828``, min 2x2), then snaps to the nearest power of two
    so the jitted frame program shape-specializes to at most a few variants.
    """
    ratio = 1.25 * float(num_train_records) / float(NUM_TRAINING_RECORDS_PER_FRAME)
    r = math.sqrt(max(ratio, 1e-12))

    def snap(v: int) -> int:
        target = max(int(v * r + 0.5), 2)
        # round to nearest power of two, clamp to [2, 64]
        p = 2 ** round(math.log2(max(target, 2)))
        return int(min(max(p, 2), 64))

    return (snap(tile_size[0]), snap(tile_size[1]))
