"""Port parity: measured BSDFs, the host tables and the lobe.

Host side (numpy on both sides): ``bake_lambert``, ``bake_ggx``,
``build_part``, ``MBSDFTableHost.build`` of two measurements (one with a
transmission part), the npz round trip and a MERL ``.binary`` file written
under ``tmp_path`` (as ``tests/test_mbsdf.py:266`` does) give the JAX
package's arrays bit for bit; the port's row tables hold those arrays'
entries bit for bit at every texel.

Device side: ``measured_sample``, ``measured_eval`` and ``measured_aux`` on
the same numpy inputs from a seed, 8192 lanes over both measurements:
random oriented normals, outgoing directions on their hemisphere, incident
directions on both, uniforms. A lane's bins are decisions on float32
angles, which XLA and PyTorch round a few ulp apart (``arccos``,
``atan2``): the theta bins of the outgoing and incident directions, the
phi bin of their folded difference, the CDF inversions ``rows <= xi`` and
the reflection-or-transmission choice. Lanes within 1e-4 of such a border
(``_edge_lanes``, in float64) are left out; every other lane is held to
``LIMITS``, each bound about ten times its largest reading over seeds 0-2,
and no lane off an edge may fall into another bin (its pdf, a product of
bin probabilities, would jump).
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.ops import mbsdf as JM
from nrc_tpu.scene import mbsdf as JH
from nrc_tpu_torch.ops import mbsdf as PM
from nrc_tpu_torch.scene import mbsdf as PH
from nrc_tpu_torch.utils.math import build_onb
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 8192
RES = (16, 32)


def _fields(x):
    return {k: getattr(x, k) for k in x.__dataclass_fields__}


def _equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None and x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


def _measurements(mod):
    ggx = mod.bake_ggx(tint=(1.0, 0.8, 0.6), alpha=0.3, res_theta=RES[0], res_phi=RES[1])
    lam = mod.bake_lambert((0.2, 0.25, 0.3), *RES)
    return [mod.Measurement(reflection=ggx.reflection, transmission=lam.reflection),
            mod.bake_lambert((0.5, 0.6, 0.7), *RES)]


@pytest.mark.parametrize("args", [dict(), dict(alpha=0.05, res_theta=8, res_phi=16),
                                  dict(tint=(0.3, 0.6, 0.9), alpha=0.8)], ids=["default", "sharp", "rough"])
def test_bakers_and_parts_are_the_jax_packages(args):
    _equal(PH.bake_ggx(**args), JH.bake_ggx(**args))
    _equal(PH.bake_lambert((0.4, 0.5, 0.6), 8, 16), JH.bake_lambert((0.4, 0.5, 0.6), 8, 16))
    grid = PH.bake_ggx(**args).reflection
    _equal(PH.build_part(grid), JH.build_part(grid))
    mono = grid[..., 1]  # a scalar grid goes to RGB first
    _equal(PH.build_part(mono), JH.build_part(mono))


def test_stacked_tables_are_the_jax_packages():
    _equal(PH.MBSDFTableHost.build(_measurements(PH)), JH.MBSDFTableHost.build(_measurements(JH)))
    _equal(PH.MBSDFTableHost.build([]), JH.MBSDFTableHost.build([]))
    with pytest.raises(AssertionError):
        PH.MBSDFTableHost.build([PH.bake_lambert(res_theta=8, res_phi=16), PH.bake_lambert(res_theta=16)])


def test_npz_and_merl_files_load_as_the_jax_package_does(tmp_path):
    m = PH.bake_ggx(alpha=0.2, res_theta=8, res_phi=16)
    path = str(tmp_path / "ggx.npz")
    np.savez(path, reflection=m.reflection, transmission=m.reflection[..., 0])
    _equal(PH.load_measurement(path), JH.load_measurement(path))
    assert np.array_equal(PH.load_measurement(path).reflection, m.reflection)
    # a MERL file of three channel blocks over (theta_half, theta_diff,
    # phi_diff), varying along every index
    n = 90 * 90 * 180
    i = np.arange(n, dtype=np.float64)
    vals = np.concatenate([1500.0 * (1.0 + np.sin(i * 1e-3)), 1000.0 + (i % 180), 800.0 + (i // 180) % 90])
    merl = str(tmp_path / "wave.binary")
    with open(merl, "wb") as f:
        f.write(struct.pack("<3i", 90, 90, 180))
        f.write(vals.astype(np.float64).tobytes())
    _equal(PH.load_measurement(merl), JH.load_measurement(merl))
    _equal(PH.load_merl(merl, res_theta=8, res_phi=16), JH.load_merl(merl, res_theta=8, res_phi=16))
    with pytest.raises(ValueError, match="measured"):
        PH.load_measurement(str(tmp_path / "paint.mbsdf"))


def test_row_tables_hold_the_stacks_entries():
    host = PH.MBSDFTableHost.build(_measurements(PH))
    rows = PM.row_tables(host)
    m, _, r, _, p, _ = host.eval.shape
    assert (rows["res_theta"], rows["res_phi"]) == (r, p)
    ev = rows["eval_rows"].reshape(m, 2, r, r, p, PM.EVAL_ROW)
    nxt_r, nxt_p = np.minimum(np.arange(r) + 1, r - 1), np.minimum(np.arange(p) + 1, p - 1)
    k = 0
    for w in (np.arange(r), nxt_r):
        for v in (np.arange(r), nxt_r):
            for u in (np.arange(p), nxt_p):
                want = host.eval[:, :, w][:, :, :, v][:, :, :, :, u]
                assert np.array_equal(ev[..., 3 * k:3 * k + 3], want)
                k += 1
    assert np.array_equal(ev[..., 24], np.broadcast_to(host.has_part[:, :, None, None, None], (m, 2, r, r, p)))
    ct = rows["cdf_theta_rows"].reshape(m, 2, r, r + 1)
    assert np.array_equal(ct[..., :r], host.cdf_theta) and np.array_equal(ct[..., r], np.repeat(
        host.has_part[:, :, None], r, axis=-1))
    assert np.array_equal(rows["cdf_phi_rows"].reshape(m, 2, r, r, p), host.cdf_phi)
    al = rows["albedo_rows"].reshape(m, r, 6)
    assert np.array_equal(al[..., 0], host.albedo[:, 0]) and np.array_equal(al[..., 1], host.albedo[:, 1])
    assert np.array_equal(al[..., 2:4], np.repeat(host.max_albedo[:, None, :], r, axis=1))
    assert np.array_equal(al[..., 4:6], np.repeat(host.has_part[:, None, :], r, axis=1))


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(seed):
    rs = np.random.default_rng(seed)
    nf = _unit(rs, N)
    wo = _unit(rs, N)
    wo = np.where(((wo * nf).sum(-1) < 0.0)[:, None], -wo, wo)
    return dict(
        idx=(rs.random(N) < 0.5).astype(np.int32),
        multiplier=rs.uniform(0.5, 1.5, N).astype(np.float32),
        nf=nf.astype(np.float32), wo=wo.astype(np.float32), wi=_unit(rs, N).astype(np.float32),
        xi=rs.random((N, 3), dtype=np.float32),
    )


def _near(x, tol=1e-4):
    """x within tol of an integer (float64)."""
    return np.abs(x - np.round(x)) < tol


def _edge_lanes(a, host, sampled_wi):
    """Lanes within 1e-4 of a border one of their bins decides on (float64
    angles from the port's float32 inputs): theta bins of wo, wi and the
    sampled direction, the phi bin of their folded differences, the CDF
    rows' values against the uniforms, and the part choice."""
    r, p = host.eval.shape[2], host.eval.shape[4]
    nf = a["nf"].astype(np.float64)
    t, b = (x.numpy().astype(np.float64) for x in build_onb(torch.from_numpy(a["nf"])))

    def angles(w):
        w = w.astype(np.float64)
        return np.arccos(np.clip(np.abs((w * nf).sum(-1)), 0, 1)), np.arctan2((w * b).sum(-1), (w * t).sum(-1))

    th_o, ph_o = angles(a["wo"])
    edge = _near(th_o * 2 / np.pi * r)
    for w in (a["wi"], sampled_wi):
        th, ph = angles(w)
        u = np.abs(np.remainder(ph - ph_o + np.pi, 2 * np.pi) - np.pi) / np.pi
        edge |= _near(th * 2 / np.pi * r) | _near(u * p) | _near(th * 2 / np.pi * r - 0.5) | _near(u * p - 0.5)
    # the uniforms against the rows they invert
    i_t = np.clip((th_o * 2 / np.pi * r).astype(np.int64), 0, r - 1)
    alb = host.albedo * host.has_part[:, :, None]
    a_r, a_t = alb[a["idx"], 0, i_t], alb[a["idx"], 1, i_t]
    p_refl = np.where(a_r + a_t > 0, a_r / np.maximum(a_r + a_t, 1e-30), 1.0)
    edge |= np.abs(a["xi"][:, 2] - p_refl) < 1e-4
    part = (a["xi"][:, 2] >= p_refl).astype(np.int64)
    rows_t = host.cdf_theta[a["idx"], part, i_t]
    edge |= (np.abs(rows_t - a["xi"][:, :1]) < 1e-4).any(-1)
    i_to = np.clip((rows_t <= a["xi"][:, :1]).sum(-1), 0, r - 1)
    xi1 = a["xi"][:, 1].astype(np.float64)
    xi1 = np.where(xi1 > 0.5, 1.0 - xi1, xi1) * 2.0
    edge |= (np.abs(host.cdf_phi[a["idx"], part, i_t, i_to] - xi1[:, None]) < 1e-4).any(-1)
    return edge


def _both(a, host):
    """(JAX, port) sample, eval and aux as numpy."""
    jt = JM.MBSDFTables(eval_data=jnp.asarray(host.eval), cdf_theta=jnp.asarray(host.cdf_theta),
                        cdf_phi=jnp.asarray(host.cdf_phi), albedo=jnp.asarray(host.albedo),
                        max_albedo=jnp.asarray(host.max_albedo), has_part=jnp.asarray(host.has_part))
    pt = PM.to_device(PM.row_tables(host), "cpu")
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.from_numpy(v.astype(np.int64) if k == "idx" else v) for k, v in a.items()}
    js = JM.measured_sample(jt, j["idx"], j["multiplier"], j["wo"], j["nf"], j["xi"])
    fr = PM.measured_frame(pt, t["idx"], t["wo"], t["nf"])  # the bounce's: once for sample, eval and aux
    ps = PM.measured_sample(pt, t["idx"], t["multiplier"], fr, t["nf"], t["xi"])
    je = JM.measured_eval(jt, j["idx"], j["multiplier"], j["wo"], j["wi"], j["nf"])
    pe = PM.measured_eval(pt, t["idx"], t["multiplier"], fr, t["wi"], t["nf"])
    ja = JM.measured_aux(jt, j["idx"], j["multiplier"], j["wo"], j["nf"])
    pa = PM.measured_aux(t["multiplier"], fr)
    return ([np.asarray(x) for x in js], [x.numpy() for x in ps], [np.asarray(x) for x in je],
            [x.numpy() for x in pe], np.asarray(ja), pa.numpy())


def _rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).reshape(a.shape[0], -1).max(-1)


# each bound about ten times the largest reading over seeds 0-2
LIMITS = {
    "bin_jumps_off_edge": 0,   # 0
    "edge_share": 0.03,        # 0.0115 of the lanes near a border
    "wi_abs": 1e-5,            # 9.2e-7
    "weight_rel": 3e-4,        # 3.3e-5 (units of max(|w|, 1))
    "pdf_rel": 3e-5,           # 3.0e-6 (units of max(pdf, 1))
    "eval_f_rel": 5e-5,        # 4.8e-6
    "eval_pdf_rel": 3e-5,      # 2.7e-6
    "aux_abs": 0.0,            # 0: the albedo row's entries, halved and clipped
}


def readings(a, host) -> dict:
    js, ps, je, pe, ja, pa = _both(a, host)
    edge = _edge_lanes(a, host, js[0])
    same = (js[3] == ps[3]) & (js[4] == ps[4])  # the part and the ok flag
    # a bin decision moves the pdf by a bin probability's ratio, not by ulps
    jump = (_rel(ps[2], js[2]) > 1e-3) | (_rel(pe[1], je[1]) > 1e-3) | ~same
    keep = ~edge & same
    return {
        "bin_jumps_off_edge": int((jump & ~edge).sum()),
        "edge_share": float(edge.mean()),
        "wi_abs": float(np.abs(ps[0] - js[0])[keep & ps[4]].max()),
        "weight_rel": float(_rel(ps[1], js[1])[keep].max()),
        "pdf_rel": float(_rel(ps[2], js[2])[keep].max()),
        "eval_f_rel": float(_rel(pe[0], je[0])[~edge].max()),
        "eval_pdf_rel": float(_rel(pe[1], je[1])[~edge].max()),
        "aux_abs": float(np.abs(pa - ja).max()),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measured_lobe_matches_jax(seed):
    host = PH.MBSDFTableHost.build(_measurements(PH))
    a = _inputs(seed)
    got = readings(a, host)
    over = {k: (v, LIMITS[k]) for k, v in got.items() if not v <= LIMITS[k]}
    assert not over, f"readings over their limits: {over}"
    # both parts are sampled, and a measurement without one never takes it
    _, ps, _, _, _, _ = _both(a, host)
    trans = ps[3] & ps[4]
    assert trans.any() and (~ps[3] & ps[4]).any() and not trans[a["idx"] == 1].any()
