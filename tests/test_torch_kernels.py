"""Plain GQMV/GQMM versions and the quantized-matmul entry points of the port,
against the reference's XLA oracle (``kernels/ref.py``) and its Pallas kernel
in interpret mode. The CUDA kernels themselves run in tests/test_torch_cuda.py.

The group sums are exact integers on both sides; the f32 outputs may differ
only by the order of the sum across groups (rtol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import qlinear as jqlinear  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gqmv import gqmm_pallas, gqmv_pallas  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _mk(m, n, gs, b, seed):
    """Reference-quantized weights and activations, and their port copies."""
    rng = np.random.default_rng(seed)
    w = jquant.quantize_groupwise(jnp.asarray(rng.normal(size=(m, n)).astype(np.float32)), gs)
    shape = (n,) if b is None else (b, n)
    x = jquant.quantize_activation(jnp.asarray(rng.normal(size=shape).astype(np.float32)), gs)
    t = [torch.from_numpy(np.array(a)) for a in (w.qvalues, w.scales, x.qvalues, x.scales)]
    return (w.qvalues, w.scales, x.qvalues, x.scales), t


@pytest.mark.parametrize("gs", [16, 32, 256])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_plain_gqmm_matches_oracle_and_pallas(gs, b):
    m, n = 64, 512
    j, t = _mk(m, n, gs, b, seed=gs * 10 + b)
    got = ref.gqmm_ref(*t, group_size=gs).numpy()
    # group sums are exact integers in the port's f32 formulation
    ng = n // gs
    sums = torch.einsum("mgk,bgk->bmg", t[0].reshape(m, ng, gs).float(),
                        t[2].reshape(b, ng, gs).float()).numpy()
    exact = np.einsum("mgk,bgk->bmg", np.asarray(j[0]).astype(np.int64).reshape(m, ng, gs),
                      np.asarray(j[2]).astype(np.int64).reshape(b, ng, gs))
    np.testing.assert_array_equal(sums.astype(np.int64), exact)
    oracle = np.asarray(jref.gqmm_ref(*j, group_size=gs))
    pallas = np.asarray(gqmm_pallas(*j, group_size=gs, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6 * np.abs(oracle).max())
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6 * np.abs(oracle).max())


@pytest.mark.parametrize("gs", [16, 32, 256])
def test_plain_gqmv_matches_oracle_and_pallas(gs):
    j, t = _mk(96, 512, gs, None, seed=gs)
    got = ref.gqmv_ref(*t, group_size=gs).numpy()
    oracle = np.asarray(jref.gqmv_ref(*j, group_size=gs))
    pallas = np.asarray(gqmv_pallas(*j, group_size=gs, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6 * np.abs(oracle).max())
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6 * np.abs(oracle).max())


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_quantized_matmul_dispatch_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    wf = rng.normal(size=(96, 256)).astype(np.float32)
    xf = rng.normal(size=(*lead, 256)).astype(np.float32)
    jw = jquant.quantize_groupwise(jnp.asarray(wf), 64)
    w = QuantizedTensor(torch.from_numpy(np.array(jw.qvalues)),
                        torch.from_numpy(np.array(jw.scales)), 64)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(xf), jw, impl="xla"))
    before = dict(kern.LAUNCHES)
    got = ops.quantized_matmul(torch.from_numpy(xf), w)
    assert kern.LAUNCHES == before            # the CPU runs the plain version
    assert tuple(got.shape) == (*lead, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_impl_resolution_and_scope():
    _, t = _mk(32, 64, 32, 2, seed=0)
    assert ops._resolve(None, t[0]) == "plain"
    assert ops._resolve("auto", t[0]) == "plain"
    with ops.impl_scope("cuda"):
        assert ops._resolve(None, t[0]) == "cuda"
        assert ops._resolve("plain", t[0]) == "plain"
    assert ops._resolve(None, t[0]) == "plain"
    with pytest.raises(ValueError, match="unknown impl"):
        ops.gqmm(*t, group_size=32, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        with ops.impl_scope("xla"):
            pass


def test_forcing_cuda_on_cpu_tensors_raises_without_fallback():
    _, t = _mk(32, 64, 32, 2, seed=1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ops.gqmm(*t, group_size=32, impl="cuda")
    _, t1 = _mk(32, 64, 32, None, seed=1)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ops.gqmv(*t1, group_size=32, impl="cuda")


@pytest.mark.parametrize("name", ["gqmm_cuda", "gqmv_cuda"])
def test_wrappers_reject_cpu_tensors_before_building(name):
    _, t = _mk(32, 64, 32, 2 if name == "gqmm_cuda" else None, seed=2)
    before = dict(kern.LAUNCHES)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        getattr(kern, name)(*t, group_size=32)
    assert kern.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_matches_reference(dtype):
    rng = np.random.default_rng(4)
    wf = rng.normal(size=(48, 128)).astype(np.float32)
    xf = rng.normal(size=(3, 128)).astype(np.float32)
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jw = jquant.quantize_groupwise(jnp.asarray(wf), 32)
    w = QuantizedTensor(torch.from_numpy(np.array(jw.qvalues)),
                        torch.from_numpy(np.array(jw.scales)), 32)
    x = torch.from_numpy(xf).to(dtype)
    got = qlinear.linear(w, x)
    want = jqlinear.linear(jw, jnp.asarray(xf).astype(jdt))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2 if dtype is torch.bfloat16 else 1e-6, atol=1e-5)
    fl = qlinear.linear(torch.from_numpy(wf), torch.from_numpy(xf))
    np.testing.assert_allclose(fl.numpy(), xf @ wf.T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_lookup_matches_reference(dtype):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(64, 128)).astype(np.float32)
    ids = np.array([[3, 0, 63], [7, 7, 1]])
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jw = jquant.quantize_groupwise(jnp.asarray(table), 32)
    w = QuantizedTensor(torch.from_numpy(np.array(jw.qvalues)),
                        torch.from_numpy(np.array(jw.scales)), 32)
    got = qlinear.embedding_lookup(w, torch.from_numpy(ids), dtype)
    want = jqlinear.embedding_lookup(jw, jnp.asarray(ids), jdt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    got_f = qlinear.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got_f.numpy(), table[ids])


def test_split_fused():
    y = torch.arange(12.0).reshape(2, 6)
    a, b = qlinear.split_fused(y, (2, 4))
    assert a.shape == (2, 2) and b.shape == (2, 4)
    with pytest.raises(ValueError, match="sum to"):
        qlinear.split_fused(y, (2, 3))
