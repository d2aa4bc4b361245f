"""Port parity: RNG (bit-exact), vector math and primary rays.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.scene.camera import generate_primary_rays as jax_primary_rays
from nrc_tpu.utils import math as JM
from nrc_tpu.utils import rng as JR
from nrc_tpu_torch.scene.camera import LENS_FISHEYE, LENS_PINHOLE, LENS_SPHERE, generate_primary_rays
from nrc_tpu_torch.scene.scene_builder import cornell_box
from nrc_tpu_torch.utils import math as PM
from nrc_tpu_torch.utils import rng as PR

N_SEEDS = 100_000


@pytest.mark.parametrize("subframe", [0, 1, 77, 2**31 + 12345, 2**32 - 1])
def test_tea_bit_exact(subframe):
    pidx = np.arange(N_SEEDS, dtype=np.uint32) * np.uint32(2654435761)
    ref = np.asarray(JR.tea(pidx, np.uint32(subframe)))
    out = PR.tea(torch.from_numpy(pidx.astype(np.int64)), subframe)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


def test_lcg_and_rng4_bit_exact():
    rs = np.random.default_rng(0)
    seeds = rs.integers(0, 2**32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    js = jnp.asarray(seeds)
    ps = torch.from_numpy(seeds.astype(np.int64))
    np.testing.assert_array_equal(
        PR.lcg_step(ps).numpy(), np.asarray(JR.lcg_step(js)).astype(np.int64)
    )
    for fn_j, fn_p in ((JR.rng, PR.rng), (JR.rng2, PR.rng2), (JR.rng3, PR.rng3),
                       (JR.rng4, PR.rng4)):
        js, ju = fn_j(js)
        ps, pu = fn_p(ps)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
        assert pu.dtype == torch.float32
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))


def test_primary_rays_match():
    """The three lenses (pinhole, fisheye, sphere) against the JAX function
    on the same jittered pixels: directions within 1e-6 (a few float32 ulp
    of a unit vector: XLA and PyTorch round sin, cos and the products
    apart), the origins equal. An unknown lens raises."""
    scene, _ = cornell_box((48, 32))
    cam = scene.camera.frustum()
    rs = np.random.default_rng(1)
    pix = np.stack(
        np.meshgrid(np.arange(48), np.arange(32), indexing="xy"), -1
    ).reshape(-1, 2).astype(np.float32)
    jitter = rs.random(pix.shape, dtype=np.float32)
    for lens in (LENS_PINHOLE, LENS_FISHEYE, LENS_SPHERE):
        jo, jd = jax_primary_rays(pix, jitter, (48, 32), *cam, lens=lens)
        po, pd = generate_primary_rays(
            torch.from_numpy(pix), torch.from_numpy(jitter), (48, 32),
            *(torch.from_numpy(c) for c in cam), lens=lens,
        )
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    # the fisheye and sphere lenses span the normalized basis
    for c in cam[1:]:
        np.testing.assert_allclose(PM.normalize(torch.from_numpy(c)).numpy(), np.asarray(JM.normalize(c)),
                                   atol=6e-8, rtol=0)
    with pytest.raises(ValueError):
        generate_primary_rays(
            torch.from_numpy(pix), torch.from_numpy(jitter), (48, 32),
            *(torch.from_numpy(c) for c in cam), lens=3,
        )


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_vector_helpers_match():
    rs = np.random.default_rng(2)
    a, b = _unit(rs, 4096), _unit(rs, 4096)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pairs = [
        (JM.cartesian_to_spherical_unit(a), PM.cartesian_to_spherical_unit(ta)),
        (JM.align_vector(a, b), PM.align_vector(ta, tb)),
        (JM.build_onb(a)[0], PM.build_onb(ta)[0]),
        (JM.build_onb(a)[1], PM.build_onb(ta)[1]),
        (JM.normalize(a * 3.0), PM.normalize(ta * 3.0)),
        (JM.reflect(a, b), PM.reflect(ta, tb)),
        (JM.cross(a, b), PM.cross(ta, tb)),
        (JM.balance_heuristic(a[:, 0] ** 2, b[:, 0] ** 2),
         PM.balance_heuristic(ta[:, 0] ** 2, tb[:, 0] ** 2)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
    z = torch.zeros(3)
    assert torch.equal(PM.safe_div(torch.ones(3), z), z)
