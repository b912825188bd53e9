"""The plain versions of the flash-attention and fused RMSNorm + quantize
kernels (``kernels/ref.py``, reached through ``kernels/ops.py``) against the
reference's Pallas kernels in interpret mode and their oracles, on the cases
of ``tests/test_flash_attn.py`` and ``tests/test_rmsnorm_quant.py``; the
port's ``_mha_blockwise`` against the reference's; the layout the model
hands the kernel; and the dispatch (a CPU tensor never reaches a kernel).

Tolerances: flash attention rtol/atol 2e-5, the reference test's own (f32
inside, another summation order). RMSNorm + quantize: scales rtol 1e-5 and
fewer than 1e-3 of the int8 values different, the reference test's rule
(an ulp of the normed value can cross a .5 boundary).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import both_flags  # noqa: E402
from repro.kernels.flash_attn import flash_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm_quant import rmsnorm_quant_pallas  # noqa: E402
from repro.kernels.rmsnorm_quant import rmsnorm_quant_ref as jrmsnorm_quant_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.registry import ARCH_IDS, load_config as jload  # noqa: E402
from repro_torch.kernels import flash_attn as flash_kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm_quant as rmsq_kern  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.registry import load_config  # noqa: E402


def _mk(bh, bkv, s, t, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((bh, s, hd), (bkv, t, hd), (bkv, t, hd))]


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


# (bh, bkv, s, t, hd, bq, bk, kwargs): every case of tests/test_flash_attn.py,
# then the head dims of the reference configs past 128: gemma2's 256 (8 / 4
# heads, window and soft cap) and zamba2's shared attention's 112
FLASH_CASES = [
    (4, 4, 128, 128, 64, 32, 32, {}),
    (4, 4, 256, 256, 32, 64, 128, {}),
    (4, 4, 64, 64, 128, 64, 64, {}),
    (16, 4, 64, 64, 32, 32, 32, {}),                                   # GQA group 4
    (2, 2, 128, 128, 32, 32, 32, dict(window=32, softcap=50.0)),
    (2, 2, 64, 64, 32, 32, 32, dict(causal=False)),
    (2, 2, 128, 128, 32, 32, 64, dict(scale=0.2)),                     # block shapes
    (4, 2, 128, 128, 256, 32, 32, dict(window=48, softcap=50.0)),      # gemma2
    (2, 2, 96, 96, 112, 32, 32, {}),                                   # zamba2
]


@pytest.mark.parametrize("bh,bkv,s,t,hd,bq,bk,kw", FLASH_CASES)
@pytest.mark.parametrize("chunk", [16, 1024])
def test_flash_plain_matches_pallas_interpret(bh, bkv, s, t, hd, bq, bk, kw, chunk):
    (jq, jk, jv), (tq, tk, tv) = _both(_mk(bh, bkv, s, t, hd, seed=s + hd))
    kw = {"scale": hd ** -0.5, **kw}
    want = flash_attention_pallas(jq, jk, jv, group=bh // bkv, block_q=bq, block_k=bk,
                                  interpret=True, **kw)
    with both_flags(attention_chunk=chunk):
        got = ops.flash_attention(tq, tk, tv, group=bh // bkv, impl="plain", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_keeps_dtype_and_cuts_chunk_to_a_divisor():
    _, (q, k, v) = _both(_mk(8, 2, 24, 24, 32, seed=1))
    a = ref.flash_attention_ref(q, k, v, group=4, scale=0.2, chunk=16)      # cut to 8
    b = ref.flash_attention_ref(q, k, v, group=4, scale=0.2, chunk=24)
    torch.testing.assert_close(a, b, atol=2e-6, rtol=0)
    out = ref.flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(), group=4,
                                  scale=0.2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


# the model types whose attention runs the reference's gqa_forward /
# gqa_prefill, and so its _mha_blockwise under blockwise_attention
# (repro/models/transformer.py for GQA decoder LMs, zamba.py's shared block,
# encdec.py); MLA decoder LMs and rwkv6 have no GQA attention
BLOCKWISE_MODEL_TYPES = ("decoder_lm", "zamba2", "encdec")


def test_flash_head_dims_cover_the_reference_blockwise_configs():
    """Every head dim of a reference config whose GQA path reaches
    _mha_blockwise (gemma2-2b's 256 and zamba2-7b's 112 among them) is one
    the port's flash kernels take."""
    seen = set()
    for arch in ARCH_IDS:
        cfg = jload(arch)
        if cfg.model_type not in BLOCKWISE_MODEL_TYPES or cfg.mla:
            continue
        seen.add(cfg.resolved_head_dim)
        assert cfg.resolved_head_dim in flash_kern.HEAD_DIMS, arch
    assert {64, 112, 128, 256} <= seen


@pytest.mark.parametrize("lengths", [None, (12, 5, 9)])
@pytest.mark.parametrize("chunk", [4, 1024])
def test_mha_blockwise_matches_reference(lengths, chunk):
    """The port's _mha_blockwise against the reference's at f32 on TinyLlama's
    reduced heads. With ragged lengths only the valid query positions are
    compared: the port masks causally only (see _mha_blockwise), so a pad
    position attends to pad keys the reference hides, and nothing reads it."""
    cfg, jcfg = load_config("tinyllama-1.1b").reduced(), jload("tinyllama-1.1b").reduced()
    b, s, hd = 3, 12, cfg.resolved_head_dim
    rng = np.random.default_rng(2)
    q = rng.normal(size=(b, s, cfg.num_heads, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, cfg.num_kv_heads, hd)).astype(np.float32) for _ in range(2))
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.as_tensor(lengths)
    with both_flags(attention_chunk=chunk):
        want = np.asarray(jattn._mha_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jcfg, lengths=jl))
        got = attention._mha_blockwise(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), cfg, lengths=tl).numpy()
    assert got.shape == want.shape == (b, s, cfg.q_dim)
    for i in range(b):
        n = s if lengths is None else lengths[i]
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=2e-5, atol=2e-5)


def test_mha_blockwise_hands_the_kernel_dense_rows(monkeypatch):
    """The model's q/k/v are strided views of the fused QKV projection; the
    kernel reads dense (b*H, s, hd) / (b*KV, t, hd) rows, so _mha_blockwise
    must hand it contiguous copies in that layout."""
    cfg = load_config("tinyllama-1.1b").reduced()
    b, s, h, kv, hd = 2, 8, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qkv = torch.randn(b, s, (h + 2 * kv) * hd)
    q, k, v = attention.split_fused(qkv, (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)
    assert not q.is_contiguous()
    seen = []

    def spy(qf, kf, vf, **kw):
        for t, shape in ((qf, (b * h, s, hd)), (kf, (b * kv, s, hd)), (vf, (b * kv, s, hd))):
            assert t.is_contiguous() and tuple(t.shape) == shape
        assert kw["group"] == h // kv
        seen.append(kw)
        return ref.flash_attention_ref(qf, kf, vf, **kw)

    monkeypatch.setattr(flash_kern, "flash_attention_cuda", spy)
    with ops.impl_scope("cuda"):
        got = attention._mha_blockwise(q, k, v, cfg)
    assert len(seen) == 1 and seen[0]["causal"] and seen[0]["window"] is None
    want = attention._mha_blockwise(q, k, v, cfg)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # head h of position p lands at out[:, p, h * hd:(h + 1) * hd]
    torch.testing.assert_close(
        got.reshape(b, s, h, hd)[:, :, 3],
        ref.flash_attention_ref(q[:, :, 3].contiguous(), k[:, :, 3 // (h // kv)].contiguous(),
                                v[:, :, 3 // (h // kv)].contiguous(), group=1,
                                scale=hd ** -0.5), atol=1e-6, rtol=0)


def test_mha_blockwise_refuses_a_per_layer_window_tensor():
    cfg = load_config("tinyllama-1.1b").reduced()
    q = torch.randn(1, 4, cfg.num_heads, cfg.resolved_head_dim)
    k = torch.randn(1, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    with pytest.raises(NotImplementedError):
        attention._mha_blockwise(q, k, k, cfg, window=2, use_window=torch.tensor(True))


# (m, n, gs): every shape of tests/test_rmsnorm_quant.py, then TinyLlama's rows
RMSQ_CASES = [(8, 128, 32), (64, 512, 256), (32, 2048, 256), (16, 256, 64),
              (4, 2048, 256), (6, 5632, 256), (5, 1024, 16)]


@pytest.mark.parametrize("m,n,gs", RMSQ_CASES)
def test_rmsnorm_quant_plain_matches_pallas_and_oracle(m, n, gs):
    rng = np.random.default_rng(m + n)
    x = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    x[0, :gs] = 0                                          # a group of zeros
    q, s = ops.rmsnorm_quant(torch.from_numpy(x), torch.from_numpy(w), group_size=gs,
                             impl="plain")
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (m, n // gs)
    assert not q[0, :gs].any() and s[0, 0] == 0
    for jq, js in (rmsnorm_quant_pallas(jnp.asarray(x), jnp.asarray(w), group_size=gs,
                                        interpret=True),
                   jrmsnorm_quant_ref(jnp.asarray(x), jnp.asarray(w), group_size=gs)):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
        assert np.mean(q.numpy() != np.asarray(jq)) < 1e-3


def test_rmsnorm_quant_plain_reads_bf16_as_f32():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = ops.rmsnorm_quant(x, w, group_size=64)
    jq, js = rmsnorm_quant_pallas(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                                  jnp.asarray(w.numpy()), group_size=64, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    assert np.mean(q.numpy() != np.asarray(jq)) < 1e-3


def test_cpu_tensors_never_reach_a_kernel():
    _, (q, k, v) = _both(_mk(8, 2, 16, 16, 32))
    x, w = torch.randn(4, 256), torch.randn(256)
    flash_kern.reset_launches()
    rmsq_kern.reset_launches()
    ops.flash_attention(q, k, v, group=4, scale=0.2)                  # auto -> plain
    ops.rmsnorm_quant(x, w, group_size=64)
    assert flash_kern.LAUNCHES["flash_attn"] == 0 and rmsq_kern.LAUNCHES["rmsnorm_quant"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, group=4, scale=0.2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm_quant(x, w, group_size=64, impl="cuda")
    with ops.impl_scope("cuda"), pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, group=4, scale=0.2)
