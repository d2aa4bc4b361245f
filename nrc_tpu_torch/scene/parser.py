"""System- and scene-description parsers (pure Python and NumPy).

The port's copy of ``nrc_tpu/scene/parser.py``, so that the reference's
text formats load without the JAX package:
- tokenizer: ``nrc/src/Parser.cpp`` (ids, numbers, quoted strings, ``#`` comments)
- system description keywords: ``Application::loadSystemDescription``
  (``nrc/src/Application.cpp:1093-1293``)
- scene description statements: ``Application::loadSceneDescription``
  (``Application.cpp:1397-2077``) — transform stack (push/pop/identity/
  rotate/scale/translate, each new transform multiplied on the left),
  ``mdl`` declarations, ``light env|point|spot|ies``,
  ``model plane|box|sphere|torus|hair|assimp``, camera/tonemapper overrides.

Output is a declarative ``SceneDescription`` consumed by ``scene_builder``.
Its ``MaterialDecl``, ``LightDecl`` and ``ModelDecl`` are the port's only
declarations: the scenes built in code (``scene_builder.cornell_box`` and
the others) declare their models and lights with them too.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..config import SystemConfig, TonemapperConfig


# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

def tokenize(text: str) -> List[str]:
    """Split into tokens; ``#`` starts a comment; quoted strings kept whole."""
    tokens: List[str] = []
    for line in text.splitlines():
        pos = 0
        while pos < len(line):
            ch = line[pos]
            if ch in " \t\r":
                pos += 1
                continue
            if ch == "#":
                break
            if ch == '"':
                end = line.find('"', pos + 1)
                if end < 0:
                    end = len(line)
                tokens.append(line[pos + 1 : end])
                pos = end + 1
                continue
            m = re.match(r"[^\s#]+", line[pos:])
            tokens.append(m.group(0))
            pos += len(m.group(0))
    return tokens


class TokenStream:
    def __init__(self, tokens: List[str]):
        self.tokens = tokens
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.tokens)

    def next(self) -> str:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def next_float(self) -> float:
        return float(self.next())

    def next_int(self) -> int:
        return int(float(self.next()))

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None


# --------------------------------------------------------------------------
# System description
# --------------------------------------------------------------------------

def parse_system_description(path: str) -> SystemConfig:
    """Parse a system description file. Last setting of an option wins."""
    with open(path, "r", errors="replace") as f:
        ts = TokenStream(tokenize(f.read()))
    cfg = SystemConfig()
    tm = cfg.tonemapper
    while not ts.eof():
        kw = ts.next()
        if kw == "strategy":
            ts.next_int()  # accepted, ignored (TPU: sharding handles this)
        elif kw == "devicesMask":
            cfg.devices_mask = ts.next_int()
        elif kw == "arenaSize":
            cfg.arena_size_mib = max(ts.next_int(), 1)
        elif kw == "interop":
            cfg.interop = ts.next_int()
        elif kw == "present":
            cfg.present = ts.next_int()
        elif kw == "peerToPeer":
            cfg.peer_to_peer = ts.next_int()
        elif kw == "resolution":
            cfg.resolution = (ts.next_int(), ts.next_int())
        elif kw == "tileSize":
            cfg.tile_size = (ts.next_int(), ts.next_int())
        elif kw == "samplesSqrt":
            cfg.samples_sqrt = max(ts.next_int(), 1)
        elif kw == "pathLengths":
            cfg.path_lengths = (ts.next_int(), ts.next_int())
        elif kw == "walkLength":
            cfg.walk_length = max(ts.next_int(), 1)
        elif kw == "epsilonFactor":
            cfg.epsilon_factor = ts.next_float()
        elif kw == "clockFactor":
            cfg.clock_factor = ts.next_float()
        elif kw == "lensShader":
            cfg.lens_shader = ts.next_int()
        elif kw == "center":
            cfg.center = (ts.next_float(), ts.next_float(), ts.next_float())
        elif kw == "camera":
            cfg.camera = (
                ts.next_float(),
                ts.next_float(),
                ts.next_float(),
                ts.next_float(),
            )
        elif kw == "prefixScreenshot":
            cfg.prefix_screenshot = ts.next()
        elif kw == "searchPath":
            cfg.search_paths = cfg.search_paths + (ts.next(),)
        elif kw == "gamma":
            tm.gamma = ts.next_float()
        elif kw == "colorBalance":
            tm.color_balance = (ts.next_float(), ts.next_float(), ts.next_float())
        elif kw == "whitePoint":
            tm.white_point = ts.next_float()
        elif kw == "burnHighlights":
            tm.burn_highlights = ts.next_float()
        elif kw == "crushBlacks":
            tm.crush_blacks = ts.next_float()
        elif kw == "saturation":
            tm.saturation = ts.next_float()
        elif kw == "brightness":
            tm.brightness = ts.next_float()
        # ignore unknown keywords (reference warns and continues)
    return cfg


# --------------------------------------------------------------------------
# Scene description
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MaterialDecl:
    reference: str          # name used in model statements
    name: str               # MDL material name
    path: str               # .mdl file path


@dataclasses.dataclass
class LightDecl:
    light_type: str                         # env | point | spot | ies
    matrix: np.ndarray                      # 4x4 object-to-world
    emission: Tuple[float, float, float]
    multiplier: float
    texture: str = ""                       # env emission texture filename
    profile: str = ""                       # IES profile filename
    spot_angle: float = 45.0                # full cone angle, degrees
    spot_exponent: float = 0.0


@dataclasses.dataclass
class ModelDecl:
    kind: str                               # plane | box | sphere | torus | hair | assimp
    matrix: np.ndarray                      # 4x4 object-to-world
    material_ref: str = ""
    args: Tuple = ()                        # kind-specific arguments
    path: str = ""                          # hair/assimp file


@dataclasses.dataclass
class SceneDescription:
    materials: List[MaterialDecl] = dataclasses.field(default_factory=list)
    lights: List[LightDecl] = dataclasses.field(default_factory=list)
    models: List[ModelDecl] = dataclasses.field(default_factory=list)
    # optional overrides of the system description
    lens_shader: Optional[int] = None
    center: Optional[Tuple[float, float, float]] = None
    camera: Optional[Tuple[float, float, float, float]] = None
    tonemapper: Optional[TonemapperConfig] = None


def _rotation_matrix(axis: np.ndarray, angle_deg: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    n = axis / max(np.linalg.norm(axis), 1e-20)
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = n
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ]
    )
    m = np.eye(4)
    m[:3, :3] = r
    return m


def parse_scene_description(path: str) -> SceneDescription:
    with open(path, "r", errors="replace") as f:
        ts = TokenStream(tokenize(f.read()))

    desc = SceneDescription()
    tm: Optional[TonemapperConfig] = None

    def get_tm() -> TonemapperConfig:
        nonlocal tm
        if tm is None:
            tm = TonemapperConfig()
            desc.tonemapper = tm
        return tm

    # Transform + emission state with a stack (reference SceneState,
    # Application.h:126-161). The matrix stack starts at identity; note the
    # reference applies new transforms on the LEFT (world-space compose).
    matrix = np.eye(4)
    stack: List[dict] = []
    state = {
        "emission": (0.0, 0.0, 0.0),
        "multiplier": 1.0,
        "texture": "",
        "profile": "",
        "spot_angle": 45.0,
        "spot_exponent": 0.0,
    }

    while not ts.eof():
        kw = ts.next()
        if kw == "push":
            stack.append({"matrix": matrix.copy(), **state})
        elif kw == "pop":
            top = stack.pop()
            matrix = top.pop("matrix")
            state = top
        elif kw == "identity":
            matrix = np.eye(4)
        elif kw == "rotate":
            ax = np.array([ts.next_float(), ts.next_float(), ts.next_float()])
            ang = ts.next_float()
            matrix = _rotation_matrix(ax, ang) @ matrix
        elif kw == "scale":
            s = np.diag([ts.next_float(), ts.next_float(), ts.next_float(), 1.0])
            matrix = s @ matrix
        elif kw == "translate":
            t = np.eye(4)
            t[:3, 3] = [ts.next_float(), ts.next_float(), ts.next_float()]
            matrix = t @ matrix
        elif kw == "emission":
            state["emission"] = (ts.next_float(), ts.next_float(), ts.next_float())
        elif kw == "emissionMultiplier":
            state["multiplier"] = ts.next_float()
        elif kw == "emissionTexture":
            state["texture"] = ts.next()
        elif kw == "emissionProfile":
            state["profile"] = ts.next()
        elif kw == "spotAngle":
            state["spot_angle"] = ts.next_float()
        elif kw == "spotExponent":
            state["spot_exponent"] = ts.next_float()
        elif kw == "mdl":
            ref = ts.next()
            name = ts.next()
            mdl_path = ts.next()
            desc.materials.append(MaterialDecl(ref, name, mdl_path))
        elif kw == "light":
            lt = ts.next()
            desc.lights.append(
                LightDecl(
                    light_type=lt,
                    matrix=matrix.copy(),
                    emission=state["emission"],
                    multiplier=state["multiplier"],
                    texture=state["texture"],
                    profile=state["profile"],
                    spot_angle=state["spot_angle"],
                    spot_exponent=state["spot_exponent"],
                )
            )
        elif kw == "model":
            kind = ts.next()
            if kind == "plane":
                tess_u, tess_v, up = ts.next_int(), ts.next_int(), ts.next_int()
                ref = ts.next()
                desc.models.append(
                    ModelDecl("plane", matrix.copy(), ref, (tess_u, tess_v, up))
                )
            elif kind == "box":
                ref = ts.next()
                desc.models.append(ModelDecl("box", matrix.copy(), ref))
            elif kind == "sphere":
                tess_u, tess_v = ts.next_int(), ts.next_int()
                theta = ts.next_float()
                ref = ts.next()
                desc.models.append(
                    ModelDecl("sphere", matrix.copy(), ref, (tess_u, tess_v, theta))
                )
            elif kind == "torus":
                tess_u, tess_v = ts.next_int(), ts.next_int()
                inner, outer = ts.next_float(), ts.next_float()
                ref = ts.next()
                desc.models.append(
                    ModelDecl("torus", matrix.copy(), ref, (tess_u, tess_v, inner, outer))
                )
            elif kind == "hair":
                scale = ts.next_float()
                ref = ts.next()
                fname = ts.next()
                desc.models.append(
                    ModelDecl("hair", matrix.copy(), ref, (scale,), path=fname)
                )
            elif kind == "assimp":
                fname = ts.next()
                # optional trailing material id
                ref = ""
                nxt = ts.peek()
                if nxt is not None and nxt not in _SCENE_KEYWORDS:
                    ref = ts.next()
                desc.models.append(ModelDecl("assimp", matrix.copy(), ref, path=fname))
            # unknown model kinds skipped
        elif kw == "lensShader":
            desc.lens_shader = ts.next_int()
        elif kw == "center":
            desc.center = (ts.next_float(), ts.next_float(), ts.next_float())
        elif kw == "camera":
            desc.camera = (
                ts.next_float(),
                ts.next_float(),
                ts.next_float(),
                ts.next_float(),
            )
        elif kw == "gamma":
            get_tm().gamma = ts.next_float()
        elif kw == "colorBalance":
            get_tm().color_balance = (ts.next_float(), ts.next_float(), ts.next_float())
        elif kw == "whitePoint":
            get_tm().white_point = ts.next_float()
        elif kw == "burnHighlights":
            get_tm().burn_highlights = ts.next_float()
        elif kw == "crushBlacks":
            get_tm().crush_blacks = ts.next_float()
        elif kw == "saturation":
            get_tm().saturation = ts.next_float()
        elif kw == "brightness":
            get_tm().brightness = ts.next_float()
        # unknown keywords skipped (reference warns)
    return desc


_SCENE_KEYWORDS = {
    "push", "pop", "identity", "rotate", "scale", "translate",
    "emission", "emissionMultiplier", "emissionTexture", "emissionProfile",
    "spotAngle", "spotExponent", "mdl", "light", "model", "lensShader",
    "center", "camera", "gamma", "colorBalance", "whitePoint",
    "burnHighlights", "crushBlacks", "saturation", "brightness",
}
