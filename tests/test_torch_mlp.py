"""Port parity: frequency encoding, the plain version of kernel K3 and cache
inference, against the JAX package.

The JAX fused MLP kernel runs in interpret mode (``force_tpu_interpret_mode``,
as ``tests/test_mlp_pallas.py`` runs it), in a child process with
synchronous dispatch (``test_torch_jax_child.py`` says why). Weights come from the JAX
``init_network`` and cross over with ``state_from_numpy``. MLP tolerances
are atol 1e-2 / rtol 1e-2: activations are re-rounded to bf16 after every
layer, and a sum taken in another order can land one bf16 ulp (2^-8
relative) apart.
"""

import jax
import numpy as np
import pytest
import torch

from nrc_tpu.config import NetworkConfig as JNetworkConfig
from nrc_tpu.models import checkpoint as JC
from nrc_tpu.models import network as JN
from nrc_tpu.ops import encodings as JE
from nrc_tpu.ops import mlp_pallas as JMP
from nrc_tpu_torch.config import NetworkConfig
from nrc_tpu_torch.models import network as N
from nrc_tpu_torch.ops import encodings as E
from nrc_tpu_torch.ops import mlp_cuda as MC
from test_torch_jax_child import run_jax_side

MLP_TOL = dict(atol=1e-2, rtol=1e-2)


def _queries(seed, n=2048):
    """Radiance queries in the layout of make_query: pos, two spherical
    directions, roughness, diffuse and specular albedo."""
    rs = np.random.default_rng(seed)
    q = np.concatenate(
        [
            rs.uniform(-0.05, 0.05, (n, 3)),
            rs.uniform(0.0, np.pi, (n, 1)), rs.uniform(-np.pi, np.pi, (n, 1)),
            rs.uniform(0.0, np.pi, (n, 1)), rs.uniform(-np.pi, np.pi, (n, 1)),
            rs.uniform(0.0, 1.0, (n, 8)),
        ],
        axis=-1,
    )
    return q.astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def fresh_xla_programs():
    """Compile the JAX side here instead of loading it from the persistent
    compilation cache (``nrc_tpu/__init__.py``), which can hold programs
    built for another CPU: one such cached encode differed by 1e-4 in exp."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(scope="module")
def jax_state():
    return JN.init_network(jax.random.PRNGKey(0), JNetworkConfig())


@pytest.mark.parametrize("domain_scale", [1.0, 32.0])
def test_encode_frequency_matches(domain_scale):
    q = _queries(0)
    ref = JE.encode_frequency(q, JNetworkConfig(freq_domain_scale=domain_scale))
    out = E.encode_frequency(torch.from_numpy(q), NetworkConfig(freq_domain_scale=domain_scale))
    assert out.shape == (q.shape[0], E.frequency_encoded_dims(NetworkConfig())) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    padded = N.encode(torch.from_numpy(q), NetworkConfig())
    np.testing.assert_allclose(
        padded.numpy(), np.asarray(JN.encode(q, JNetworkConfig(), None)), atol=1e-6, rtol=0
    )


def _jax_k3(w_in, w_hidden, w_out, x, output_relu):
    """The TPU kernel K3 in interpret mode (in the child process)."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return {"out": JMP.fused_forward(w_in, w_hidden, w_out, x, output_relu=bool(output_relu))}


@pytest.mark.parametrize("output_relu", [True, False])
def test_plain_k3_matches_tpu_kernel(jax_state, output_relu, tmp_path):
    x = np.random.default_rng(1).normal(size=(1000, MC.LANE)).astype(np.float32)
    p = jax_state.params
    ref = run_jax_side("test_torch_mlp:_jax_k3", tmp_path, w_in=np.asarray(p.w_in), w_hidden=np.asarray(p.w_hidden),
                       w_out=np.asarray(p.w_out), x=x, output_relu=np.bool_(output_relu))["out"]
    w = [torch.from_numpy(np.array(a)) for a in (p.w_in, p.w_hidden, p.w_out)]
    out = MC.fused_forward_plain(*w, torch.from_numpy(x), output_relu)
    assert out.shape == (1000, MC.OUT_PAD) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MLP_TOL)
    assert torch.equal(MC.fused_forward(*w, torch.from_numpy(x), output_relu), out)


def test_infer_matches_jax(jax_state):
    q = _queries(2)
    state = N.state_from_numpy(jax.tree.map(np.asarray, jax_state))
    ref = np.asarray(JN.infer(jax_state, q, JNetworkConfig()))
    out = N.infer(state, torch.from_numpy(q), NetworkConfig())
    assert out.shape == (q.shape[0], 3)
    assert (out >= 0).all()  # output ReLU at inference
    np.testing.assert_allclose(out.numpy(), ref, **MLP_TOL)


def test_state_from_checkpoint_keys(jax_state):
    flat = {k: np.asarray(v) for k, v in JC._flatten(jax_state).items()}
    a = N.state_from_numpy(flat)
    b = N.state_from_numpy(jax.tree.map(np.asarray, jax_state))
    for name in ("w_in", "w_hidden", "w_out"):
        ref = torch.tensor(flat[f"ema.{name}"])
        assert torch.equal(getattr(a.ema, name), ref)
        assert torch.equal(getattr(b.ema, name), ref)
        assert torch.equal(getattr(a.opt.mu, name), torch.zeros_like(ref))
    assert int(a.opt.step) == 0


def test_init_network_layout_and_seed():
    cfg = NetworkConfig()
    a = N.init_network(torch.Generator().manual_seed(3), cfg)
    b = N.init_network(torch.Generator().manual_seed(3), cfg)
    c = N.init_network(torch.Generator().manual_seed(4), cfg)
    assert torch.equal(a.ema.w_in, b.ema.w_in) and not torch.equal(a.ema.w_in, c.ema.w_in)
    d_in = E.frequency_encoded_dims(cfg)
    assert a.params.w_in.shape == (128, 64) and a.params.w_hidden.shape == (4, 64, 64)
    assert a.params.w_out.shape == (64, 16)
    assert torch.all(a.params.w_in[d_in + 1:] == 0) and torch.all(a.params.w_out[:, 3:] == 0)
    bound = np.sqrt(6.0 / (d_in + 1))
    assert a.params.w_in.abs().max() <= bound
    assert torch.equal(N.mlp_forward(a.ema, N.encode(torch.zeros(2, 15), cfg)), N.infer(a, torch.zeros(2, 15), cfg))


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(8, MC.LANE)
    st = N.init_network(torch.Generator().manual_seed(0), NetworkConfig())
    N.mlp_forward(st.ema, x)
    assert MC.FORWARD_KERNEL.launches == 0
    assert MC.FORWARD_KERNEL._fn is None  # nothing was built


def test_hash_encoding_is_not_ported():
    """What of the hash encoding is not ported: the level-sharded grid
    (``hash_shard_axis``), which waits for the multi-GPU port. The grid on
    one device is (``tests/test_torch_hash.py``)."""
    from nrc_tpu_torch.config import InputEncoding

    st = N.init_network(torch.Generator(), NetworkConfig(encoding=InputEncoding.HASH))
    assert st.grid.table.shape == (16, 2 ** 15, 2)
    with pytest.raises(NotImplementedError):
        N.init_network(torch.Generator(), NetworkConfig(encoding=InputEncoding.HASH, hash_shard_axis="data"))
