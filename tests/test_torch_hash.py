"""Port parity for the hash-grid encoding: the level constants, the corner
indices and weights, the lookup (H1's plain version), its adjoint (H2's plain
version) and the composite encoding, against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
lookup on the CPU takes autodiff's scatter adjoint (its one-hot adjoint is
for TPUs only), which is what the port's adjoint is held to. Grids: the
shipped one (16 levels, 2^15 rows, 2 features, base 16: one dense level)
and small ones with dense and hashed levels and 1, 4 or 8 features a level;
positions reach outside [0, 1], where dense levels clamp and hashed levels
wrap a negative cell coordinate as uint32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrc_tpu.config import InputEncoding as JInputEncoding
from nrc_tpu.config import NetworkConfig as JNetworkConfig
from nrc_tpu.ops import encodings as JE
from nrc_tpu_torch.config import InputEncoding, NetworkConfig
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import encodings as E
from nrc_tpu_torch.ops import hash_cuda as HC
from nrc_tpu_torch.tools import bench_hash as BH
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

GRIDS = {
    "full": {},
    "edge": dict(hash_log2_size=10, hash_base_resolution=4),
    "f1": dict(hash_n_levels=6, hash_log2_size=12, hash_base_resolution=8, hash_n_features_per_level=1),
    "f4": dict(hash_n_levels=8, hash_log2_size=12, hash_base_resolution=2, hash_per_level_scale=1.5,
               hash_n_features_per_level=4),
    "f8": dict(hash_n_levels=4, hash_log2_size=9, hash_base_resolution=3, hash_n_features_per_level=8),
}


def _cfgs(name):
    kw = GRIDS[name]
    return (JNetworkConfig(encoding=JInputEncoding.HASH, **kw),
            NetworkConfig(encoding=InputEncoding.HASH, **kw))


def _positions(seed, n=1001):
    """Uniform in [-0.3, 1.3]^3, plus cell boundaries and far negatives."""
    rs = np.random.default_rng(seed)
    pos = rs.uniform(-0.3, 1.3, (n, 3)).astype(np.float32)
    pos[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.25, 0.125], [-2.5, -1.0, 3.75]]
    return pos


def _table(cfg, seed):
    rs = np.random.default_rng(seed)
    shape = (cfg.hash_n_levels, 2 ** cfg.hash_log2_size, cfg.hash_n_features_per_level)
    return rs.uniform(-1.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_level_constants_match_jax(grid):
    jcfg, cfg = _cfgs(grid)
    assert E._level_resolutions(cfg) == JE._level_resolutions(jcfg)
    assert E._dense_levels(cfg) == JE._dense_levels(jcfg)
    assert E.hash_encoded_dims(cfg) == JE.hash_encoded_dims(jcfg)
    spec = E.grid_spec(cfg)
    assert spec.table_shape == tuple(_table(cfg, 0).shape)
    dense = E._dense_levels(cfg)
    assert any(dense) and not all(dense), "the grid has no dense or no hashed level"


@pytest.mark.parametrize("grid", ["full", "edge", "f4"])
@pytest.mark.parametrize("corner", range(8))
def test_corner_indices_and_weights_match_jax(grid, corner):
    """Indices bit for bit; weights too (the same three f32 products in the
    same order: 0 seen; within 1 ulp allowed for a contracted product)."""
    jcfg, cfg = _cfgs(grid)
    pos = _positions(corner)
    ji, jw = JE._corner_index_weight_all_levels(jnp.asarray(pos), corner, jcfg)
    pi, pw = E._corner_index_weight_all_levels(torch.from_numpy(pos), corner, cfg)
    assert pi.dtype == torch.int64 and pw.dtype == torch.float32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi.min() >= 0 and pi.max() < 2 ** cfg.hash_log2_size
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=2 ** -23, atol=0)


def test_hash_of_negative_cells_wraps_as_uint32():
    """The plain hash in int64 on masked factors against uint32 arithmetic
    in numpy, on cell coordinates of both signs."""
    cfg = NetworkConfig(encoding=InputEncoding.HASH, hash_n_levels=1, hash_base_resolution=1 << 20)
    spec = E.grid_spec(cfg)
    assert spec.dense == (False,)
    rs = np.random.default_rng(3)
    pos = rs.uniform(-3.0, 3.0, (500, 3)).astype(np.float32)
    idx, _ = HC.corner_index_weight(torch.from_numpy(pos), 0, spec)
    cell = np.floor(pos * np.float32(1 << 20)).astype(np.int32).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = cell[:, 0] * np.uint32(1) ^ cell[:, 1] * np.uint32(2654435761) ^ cell[:, 2] * np.uint32(805459861)
    np.testing.assert_array_equal(idx[:, 0].numpy(), (h & np.uint32(2 ** 15 - 1)).astype(np.int64))
    assert (pos < 0).any(axis=1).mean() > 0.5


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_lookup_matches_jax(grid):
    """Features within 1e-6 of the table's scale: the same 8 products and
    adds in the same order (0 seen; XLA may contract a multiply-add)."""
    jcfg, cfg = _cfgs(grid)
    pos, table = _positions(11), _table(cfg, 12)
    ref = np.asarray(JE.hash_grid_lookup(jnp.asarray(pos), JE.HashGridParams(jnp.asarray(table)), jcfg))
    got = E.hash_grid_lookup(torch.from_numpy(pos), E.HashGridParams(torch.from_numpy(table)), cfg)
    assert got.shape == ref.shape == (pos.shape[0], cfg.hash_n_levels * cfg.hash_n_features_per_level)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_lookup_keeps_leading_dims():
    _, cfg = _cfgs("edge")
    pos = torch.from_numpy(_positions(13, 60)).view(3, 20, 3)
    table = E.HashGridParams(torch.from_numpy(_table(cfg, 14)))
    out = E.hash_grid_lookup(pos, table, cfg)
    assert out.shape == (3, 20, 32)
    assert torch.equal(out.view(60, 32), E.hash_grid_lookup(pos.reshape(60, 3), table, cfg))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_adjoint_matches_jax_vjp(grid):
    """The table's gradient through ``HashGridLookup`` against ``jax.vjp``
    of ``hash_grid_lookup``: sums of the same terms in another order
    (largest difference 2.9e-6 of entries up to 8.3 seen)."""
    jcfg, cfg = _cfgs(grid)
    pos, table = _positions(21), _table(cfg, 22)
    g = np.random.default_rng(23).normal(size=(pos.shape[0], cfg.hash_n_levels * cfg.hash_n_features_per_level))
    g = g.astype(np.float32)
    _, vjp = jax.vjp(lambda t: JE.hash_grid_lookup(jnp.asarray(pos), JE.HashGridParams(t), jcfg),
                     jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    out = E.hash_grid_lookup(torch.from_numpy(pos), E.HashGridParams(t), cfg)
    out.backward(torch.from_numpy(g))
    d = np.abs(t.grad.numpy() - ref)
    assert d.max() <= 1e-5 * np.abs(ref).max(), d.max()
    assert (ref != 0).sum() > 0


def test_autograd_reads_a_strided_gradient_and_gives_the_plain_adjoint():
    """Through a [B, 128] layout, as K4's dX reaches the lookup, the
    backward is the plain adjoint bit for bit; positions get no gradient."""
    _, cfg = _cfgs("full")
    spec = E.grid_spec(cfg)
    pos = torch.from_numpy(_positions(31, 300)).requires_grad_(True)
    table = torch.from_numpy(_table(cfg, 32)).requires_grad_(True)
    feats = E.hash_grid_lookup(pos, E.HashGridParams(table), cfg)
    x = torch.cat([feats, torch.ones(300, 1), torch.zeros(300, 95)], dim=-1)
    g = torch.from_numpy(np.random.default_rng(33).normal(size=(300, 128)).astype(np.float32))
    x.backward(g)
    ref = HC.hash_grid_adjoint_plain(pos.detach(), g[:, :32].contiguous(), spec)
    assert torch.equal(table.grad, ref)
    assert pos.grad is None


@pytest.mark.parametrize("grid", ["full", "edge"])
def test_adjoint_order_within_card_limits_and_faults_above(grid):
    """What ``bench_hash.CARD_LIMITS`` rests on: the same adjoint summed in
    another order (the queries shuffled, as H2's atomics reorder the sums)
    reads far under the limits (2.9e-8 and 4.4e-7 at most), and the seeded
    faults far above (0.18 or more)."""
    _, cfg = _cfgs(grid)
    spec = E.grid_spec(cfg)
    gen = torch.Generator().manual_seed(41)
    for lo, hi in ((-0.1, 1.1), (0.25, 0.75)):
        pos, _, g = BH.inputs(spec, 4096, gen, "cpu", lo, hi)
        ref = HC.hash_grid_adjoint_plain(pos, g, spec)
        perm = torch.randperm(pos.shape[0], generator=gen)
        gap = BH.adjoint_gap(HC.hash_grid_adjoint_plain(pos[perm], g[perm], spec), ref)
        assert all(gap[k] <= BH.CARD_LIMITS[k] / 20 for k in gap), gap
        assert BH.within_limits(gap)
        for name, fault in BH.FAULTS.items():
            reading = BH.adjoint_gap(fault(pos, g, spec), ref)
            assert BH.above_limits(reading) and min(reading.values()) > 1e-2, (name, reading)


@pytest.mark.parametrize("grid", ["full", "edge"])
def test_sliced_grid_is_the_whole_grids_levels(grid):
    """``bench_hash.sliced``, the grid cut to some of its levels (H2 is timed
    on the dense and on the hashed levels alone through it): its lookup is
    the whole grid's columns of those levels and its adjoint the whole
    grid's rows, bit for bit."""
    _, cfg = _cfgs(grid)
    spec = E.grid_spec(cfg)
    n_dense, F = sum(spec.dense), spec.features
    assert 0 < n_dense < spec.levels
    pos = torch.from_numpy(_positions(71))
    table = torch.from_numpy(_table(cfg, 72))
    g = torch.from_numpy(np.random.default_rng(73).standard_normal((pos.shape[0], spec.levels * F), np.float32))
    out = HC.hash_grid_lookup_plain(pos, table, spec)
    adj = HC.hash_grid_adjoint_plain(pos, g, spec)
    for lo, hi in ((0, n_dense), (n_dense, spec.levels)):
        part = BH.sliced(spec, lo, hi)
        assert part.levels == hi - lo and part.table_shape == (hi - lo, spec.size, F)
        assert torch.equal(HC.hash_grid_lookup_plain(pos, table[lo:hi].contiguous(), part), out[:, lo * F:hi * F])
        assert torch.equal(HC.hash_grid_adjoint_plain(pos, g[:, lo * F:hi * F].contiguous(), part), adj[lo:hi])


def test_encode_hash_matches_jax():
    jcfg, cfg = _cfgs("full")
    rs = np.random.default_rng(51)
    q = rs.random((400, 15), np.float32)
    q[:, :3] = (q[:, :3] - 0.5) * 0.12   # frame positions: about [-0.05, 0.05], some beyond
    table = _table(cfg, 52) * 1e-2
    ref = np.asarray(JE.encode_hash(jnp.asarray(q), JE.HashGridParams(jnp.asarray(table)), jcfg))
    got = E.encode_hash(torch.from_numpy(q), E.HashGridParams(torch.from_numpy(table)), cfg)
    assert got.shape == ref.shape == (400, 62) == (400, E.hash_encoded_dims(cfg))
    np.testing.assert_allclose(got[:, :32].numpy(), ref[:, :32], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[:, 32:56].numpy(), ref[:, 32:56], rtol=1e-5, atol=1e-6)  # exp
    np.testing.assert_array_equal(got[:, 56:].numpy(), ref[:, 56:])
    x = N.encode(torch.from_numpy(q), cfg, E.HashGridParams(torch.from_numpy(table)))
    assert x.shape == (400, 128)
    assert torch.equal(x[:, :62], got) and torch.all(x[:, 62] == 1.0) and torch.all(x[:, 63:] == 0.0)


def test_init_hash_grid_shape_and_range():
    _, cfg = _cfgs("full")
    table = E.init_hash_grid(torch.Generator().manual_seed(0), cfg).table
    assert table.shape == (16, 2 ** 15, 2) and table.dtype == torch.float32
    assert table.abs().max() <= 1e-4 and table.min() < -9e-5 and table.max() > 9e-5
    assert abs(table.mean().item()) < 1e-6
    again = E.init_hash_grid(torch.Generator().manual_seed(0), cfg).table
    assert torch.equal(table, again)
    st = N.init_network(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(st.ema_grid.table, st.grid.table) and st.grid.table.data_ptr() != st.ema_grid.table.data_ptr()
    assert not st.opt.mu_grid.any() and not st.opt.nu_grid.any() and st.grid.table.requires_grad
    # the inputs beyond the 62 encoded columns and the ones channel have no weights
    d_in = E.hash_encoded_dims(cfg)
    assert torch.all(st.params.w_in[d_in + 1:] == 0) and torch.all(st.params.w_in[:d_in + 1] != 0)


def test_cpu_tensors_take_the_plain_versions():
    _, cfg = _cfgs("edge")
    table = torch.from_numpy(_table(cfg, 61)).requires_grad_(True)
    E.hash_grid_lookup(torch.from_numpy(_positions(62, 50)), E.HashGridParams(table), cfg).sum().backward()
    for k in (HC.LOOKUP_KERNEL, HC.ADJOINT_KERNEL):
        assert k.launches == 0 and k._fn is None  # nothing was built


@pytest.mark.parametrize("kw,what", [
    (dict(hash_n_features_per_level=3), "features"),
    (dict(hash_n_levels=33), "levels"),
    (dict(hash_log2_size=31), "log2"),
])
def test_specs_the_kernels_do_not_take_raise(kw, what):
    spec = E.grid_spec(NetworkConfig(encoding=InputEncoding.HASH, **kw))
    with pytest.raises(ValueError, match=what):
        HC.check_spec(spec)
