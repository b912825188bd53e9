"""Plain versions of the port's kernels (GQMV/GQMM, paged decode attention)
and their entry points, against the reference's XLA oracle
(``kernels/ref.py``) and its Pallas kernels in interpret mode. The CUDA
kernels themselves run in tests/test_torch_cuda.py.

The group sums are exact integers on both sides; the f32 outputs may differ
only by the order of the sum across groups (rtol 1e-6). Paged attention
sums softmax-weighted rows in f32 in another order (rtol 1e-5).
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
from repro.kernels.paged_attn import paged_attention_pallas  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attn as paged_kern  # noqa: E402


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


# ---------------------------------------------------------------------------
# paged decode attention (B8 float pool, B9 int8/fp8 pool)
# ---------------------------------------------------------------------------

def _paged_inputs(pool: str, softcap, seed: int, b=3, kv=2, g=4, hd=16, bs=4, mb=6):
    """Random pool, a non-identity table whose entries past each row's
    position point at the sink block 0 (stale data there), random positions
    and the decode mask: as numpy, for both packages."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    shape = (nb, bs, kv, hd)
    q = rng.normal(size=(b, kv, g, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(b, kv, hd)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, mb * bs, size=(b,))
    table = (rng.permutation(nb - 1)[: b * mb] + 1).reshape(b, mb)
    table = np.where(np.arange(mb)[None, :] > pos[:, None] // bs, 0, table).astype(np.int32)
    mask = np.where(np.arange(mb * bs)[None, :] <= pos[:, None], 0.0, -1e30).astype(np.float32)
    out = dict(q=q, k_new=kn, v_new=vn, pos=pos, table=table, mask=mask)
    if pool == "float":
        out["k_pages"], out["v_pages"] = (rng.normal(size=shape).astype(np.float32)
                                          for _ in range(2))
    else:
        jdt = jnp.int8 if pool == "int8" else jnp.float8_e4m3fn
        for name in ("k", "v"):
            vals = rng.normal(size=shape) * (40 if pool == "int8" else 100)
            vals = np.clip(np.round(vals) if pool == "int8" else vals, -127, 127)
            out[f"{name}_pages"] = np.asarray(jnp.asarray(vals, jnp.float32).astype(jdt))
            out[f"{name}_scales"] = rng.uniform(1e-3, 2e-2, size=shape[:-1]).astype(np.float32)
    out["softcap"] = softcap
    return out


def _paged_call(fn, a, to, **kw):
    quant = "k_scales" in a
    return fn(to(a["q"]), to(a["k_pages"]), to(a["v_pages"]), to(a["table"]), to(a["pos"]),
              to(a["k_new"]), to(a["v_new"]), to(a["mask"]), scale=0.25, softcap=a["softcap"],
              k_scales=to(a["k_scales"]) if quant else None,
              v_scales=to(a["v_scales"]) if quant else None, **kw)


def _to_torch(x):
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(np.array(x).view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
def test_plain_paged_attention_matches_oracle_and_pallas(pool, softcap):
    a = _paged_inputs(pool, softcap, seed={"float": 0, "int8": 1, "fp8": 2}[pool])
    got = _paged_call(ref.paged_attention_ref, a, _to_torch).numpy()
    oracle = np.asarray(_paged_call(jref.paged_attention_ref, a, jnp.asarray))
    pallas = np.asarray(_paged_call(paged_attention_pallas, a, jnp.asarray, interpret=True))
    assert got.shape == (3, 2 * 4 * 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5 * np.abs(oracle).max())
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5 * np.abs(oracle).max())


def test_plain_paged_attention_ignores_stale_pool_rows():
    """The row at pos and every masked row may hold anything finite: the
    current token's K/V replace the first, the mask hides the rest."""
    a = _paged_inputs("float", None, seed=3)
    base = _paged_call(ref.paged_attention_ref, a, _to_torch)
    stale = dict(a, k_pages=a["k_pages"] * 0 + 1e3, v_pages=a["v_pages"] * 0 - 1e3)
    for i, p in enumerate(a["pos"]):
        for t in range(p):              # keep the committed rows
            blk, off = a["table"][i, t // 4], t % 4
            stale["k_pages"][blk, off] = a["k_pages"][blk, off]
            stale["v_pages"][blk, off] = a["v_pages"][blk, off]
    assert torch.equal(_paged_call(ref.paged_attention_ref, stale, _to_torch), base)


def test_paged_attention_dispatch_and_no_fallback():
    a = _paged_inputs("int8", None, seed=4)
    before = dict(paged_kern.LAUNCHES)
    got = _paged_call(ops.paged_attention, a, _to_torch)
    assert paged_kern.LAUNCHES == before          # the CPU runs the plain version
    torch.testing.assert_close(got, _paged_call(ref.paged_attention_ref, a, _to_torch))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _paged_call(ops.paged_attention, a, _to_torch, impl="cuda")
    with ops.impl_scope("cuda"), pytest.raises(ValueError, match="must be a CUDA tensor"):
        _paged_call(ops.paged_attention, a, _to_torch)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        _paged_call(paged_kern.paged_attention_cuda, a, _to_torch)
    assert paged_kern.LAUNCHES == before


def test_paged_kernel_shared_memory_sizing():
    # TinyLlama (G 8, hd 64) at the serve CLI's block sizes fits the 227 KB a
    # CTA can opt into with every pool type, an int8/fp8 pool the static 48 KB
    for bs in (8, 16):
        for elt, quant in ((2, False), (4, False), (1, True)):
            assert paged_kern.smem_bytes(8, 64, bs, elt, quant) <= paged_kern.MAX_SMEM
        assert paged_kern.smem_bytes(8, 64, bs, 1, True) <= 48 * 1024
    # an f32 pool of 128-row blocks at hd 128 does not fit: the wrapper refuses it
    assert paged_kern.smem_bytes(8, 128, 128, 4, False) > paged_kern.MAX_SMEM


def test_kernel_bounds_from_tinyllama_shapes():
    """The shape-derived bounds PERF.md quotes beside the kernels' times."""
    from repro_torch.configs.tinyllama_1_1b import CONFIG
    from repro_torch.kernels import bounds

    assert sum(c for _, _, c in bounds.projections(CONFIG)) == 89
    rows = {(name, work): b for name, work, b in bounds.table(CONFIG)}
    int8 = rows[("B1 gqmv_pallas (int8)", "one pass, b=1")]
    assert int8.bound_by == "bytes" and abs(int8.seconds - 314.2e-6) < 0.1e-6
    # int4 and int3 store a half and three eighths of int8's weight bytes
    int4 = rows[("B5 gqmv_int4_pallas", "one pass, b=1")]
    int3 = rows[("B6 gqmv_int3_pallas", "one pass, b=1")]
    weights = sum(m * n * c for m, n, c in bounds.projections(CONFIG))
    assert int8.nbytes - int4.nbytes == weights // 2
    assert int8.nbytes - int3.nbytes == 5 * weights // 8
    # B2 at bf16 and f32 input (the kernel reads either, computes in f32);
    # B4 at TinyLlama's 4 x 64 prefill is bound by bytes, at 1 x 2048 by the
    # bf16 tensor-core rate over the causal half of the products
    b2 = rows[("B2 rmsnorm_quant_pallas", "one call, bf16 (4, 2048)")]
    b2f = rows[("B2 rmsnorm_quant_pallas", "one call, f32 (4, 2048)")]
    assert b2f.nbytes - b2.nbytes == 2 * (4 * 2048 + 2048)
    long = rows[("B4 flash_attention_pallas", "one layer, bf16 1 x 2048 tokens")]
    assert long.bound_by == "operations" and long.ops == 4 * 32 * 64 * 2048 * 2049 // 2
    # the prefill's b = 256 pass: the integer formats by bytes at the int8
    # tensor rate, fp8 (e4m3 x int8 on the f16 tensor cores) by operations
    fp8 = rows[("B7 gqmm_fp8_pallas", "one pass, b=256")]
    assert fp8.bound_by == "operations" and fp8.rate == "bf16"
    assert all(b.bound_by == "bytes" for (_, work), b in rows.items()
               if "1 x 2048" not in work and b is not fp8)
