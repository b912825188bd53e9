"""The register-tiled f32 flash-attention kernel (``csrc/flash_attn.cu``,
``flash_attn_f32_kernel``): its arithmetic emulated in plain PyTorch on the
CPU and held against the reference package's ``flash_attention_pallas`` in
interpret mode, and its tile constants and shared memory against the CUDA
source (the kernel itself runs in tests/test_torch_cuda.py on the card).

The emulation follows the kernel: 64 query rows a CTA; K/V tiles of
``flash_attn.f32_keys(hd)`` keys (zero-filled past t); S formed per d-split
as f32 FMAs left to right over the split's 16-byte d-chunks, the splits
added as an xor butterfly; scale, soft cap, masks on edge tiles (keys past t
at -inf, masked keys at -1e30); the row max; the row sum as each lane's four
keys (kg + KG j) left to right, then a pairwise tree over the key groups;
l = fma(l, alpha, sum), O *= alpha, then O += P V by FMAs in the order of
the P vectors (keys e, e + KG, e + 2 KG, e + 3 KG for e = 0 .. KG - 1);
tiles above the diagonal or wholly outside the window skipped. FMAs are
emulated in f64 (the product is exact there) and rounded to f32.
Tolerance: the f32 one the card holds the kernel to, 1e-5 * max|out|
(another order of f32 sums).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attn as fk  # noqa: E402

NEG_INF = -1e30
FLASH_TOL = 1e-5      # f32: the tolerance of chip_smoke.FLASH_TOL and the card tests
SRC = (Path(fk.__file__).resolve().parents[1] / "csrc" / "flash_attn.cu").read_text()


def _fma(a, b, c):
    """a * b + c rounded once to f32 (a * b is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _tree(x):
    """The xor butterfly over the last axis: a pairwise tree in lane order."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def flash_f32_emulation(q, k, v, *, group, scale, causal=True, window=None, softcap=None):
    bh, s, hd = q.shape
    t = k.shape[1]
    keys, splits, bq = fk.f32_keys(hd), fk.f32_splits(hd), fk.F32_BQ
    kgs = keys // 4
    pad = -(-t // keys) * keys - t
    kk = torch.nn.functional.pad(k.repeat_interleave(group, 0), (0, 0, 0, pad))
    vv = torch.nn.functional.pad(v.repeat_interleave(group, 0), (0, 0, 0, pad))
    order = [e + kgs * j for e in range(kgs) for j in range(4)]
    out = torch.empty_like(q)
    for q0 in range(0, s, bq):
        nq = min(bq, s - q0)
        qt = torch.zeros((bh, bq, hd))
        qt[:, :nq] = q[:, q0:q0 + nq]
        qp = torch.arange(q0, q0 + bq)[:, None]
        k_end = min(t, q0 + nq) if causal else t
        k_begin = (max(0, q0 - window + 1) // keys) * keys if window else 0
        m = torch.full((bh, bq), NEG_INF)
        l = torch.zeros((bh, bq))
        o = torch.zeros((bh, bq, hd))
        for k0 in range(k_begin, k_end, keys):
            kt, vt = kk[:, k0:k0 + keys], vv[:, k0:k0 + keys]
            part = torch.zeros((bh, bq, keys, splits))
            for u in range(hd // 4 // splits):
                for dd in range(4):
                    d = 4 * (torch.arange(splits) + splits * u) + dd
                    part = _fma(qt[:, :, None, d], kt[:, None, :, d], part)
            x = _tree(part) * scale
            if softcap:
                x = softcap * torch.tanh(x / softcap)
            edge = (k0 + keys > t or (causal and k0 + keys - 1 > q0)
                    or bool(window and q0 + bq - 1 - k0 >= window))
            if edge:
                kp = torch.arange(k0, k0 + keys)[None, :]
                bad = torch.zeros((bq, keys), dtype=torch.bool)
                if causal:
                    bad |= kp > qp
                if window:
                    bad |= qp - kp >= window
                x = torch.where(bad, torch.tensor(NEG_INF), x)
                x = torch.where(kp >= t, torch.tensor(-float("inf")), x)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            lanes = p.reshape(bh, bq, 4, kgs)            # [..., j, kg]: key kg + KG j
            lanes = ((lanes[:, :, 0] + lanes[:, :, 1]) + lanes[:, :, 2]) + lanes[:, :, 3]
            l = _fma(l, alpha, _tree(lanes))
            o = o * alpha[..., None]
            for key in order:
                o = _fma(p[:, :, key, None], vt[:, None, key, :], o)
            m = m_new
        out[:, q0:q0 + nq] = (o / torch.clamp(l, min=1e-30)[..., None])[:, :nq]
    return out


# (name, b*H, b*KV, s, t, causal, window, softcap); s and t are no multiple
# of any K/V tile (ragged last tiles), and t != s where not causal
CASES = [("causal", 8, 2, 136, 136, True, None, None),
         ("non_causal", 8, 2, 72, 136, False, None, None),
         ("window48_cap50", 8, 2, 136, 136, True, 48, 50.0)]


@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f32_design_within_tolerance_of_pallas(hd, case):
    _, bh, bkv, s, t, causal, window, softcap = case
    rng = np.random.default_rng(hd + s + t)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((bh, s, hd), (bkv, t, hd), (bkv, t, hd)))
    kw = dict(group=bh // bkv, scale=hd ** -0.5, causal=causal, window=window, softcap=softcap)
    got = flash_f32_emulation(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()
    want = np.asarray(flash_attention_pallas(*(jnp.asarray(a) for a in (q, k, v)),
                                             interpret=True, **kw))
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= FLASH_TOL * np.abs(want).max(), err


def _cuda_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_f32_tiles_and_smem_mirror_the_cuda_source():
    """The f32 kernel's constants and per-head-dim tiles in csrc/flash_attn.cu
    equal kernels/flash_attn.py's; its shared memory, summed region by
    region, is f32_smem_bytes; two CTAs (each with the 1 KB the card
    reserves a block) fit the SM's 228 KB, and one CTA the 232,448 bytes a
    block may opt into, at every head dim."""
    assert _cuda_int("kF32Threads") == fk.F32_THREADS
    assert _cuda_int("kF32BQ") == fk.F32_BQ
    assert _cuda_int("kF32Lanes") == fk.F32_LANES and _cuda_int("kF32Rows") == fk.F32_ROWS
    assert fk.F32_BQ == fk.F32_ROWS * fk.F32_THREADS // fk.F32_LANES
    assert "return HD <= 112 ? 64 : HD <= 128 ? 32 : 16;" in SRC
    assert "return kF32Lanes * 4 / f32_keys<HD>();" in SRC
    assert "return HD + (f32_splits<HD>() == 1 ? 4 : f32_splits<HD>() == 2 ? 12 : 16);" in SRC
    assert "__launch_bounds__(kF32Threads, 2)" in SRC
    for hd in fk.HEAD_DIMS:
        keys, splits, row = fk.f32_keys(hd), fk.f32_splits(hd), fk.f32_row_floats(hd)
        assert (keys // 4) * splits == fk.F32_LANES
        assert (hd // 4) % splits == 0 and row % 4 == 0
        # the row stride in 16-byte chunks puts a warp's reads in distinct bank groups
        assert (row // 4) % 8 in {1: {1, 3, 5, 7}, 2: {3, 5}, 4: {4}}[splits]
        regions = [4 * fk.F32_BQ * row, 4 * keys * row, 4 * keys * row,
                   4 * fk.F32_BQ * (keys + 4)]
        assert fk.f32_smem_bytes(hd) == sum(regions)
        assert all(r % 16 == 0 for r in regions)    # every region starts 16-byte aligned
        assert 2 * (fk.f32_smem_bytes(hd) + 1024) <= 228 * 1024
        assert 2 * fk.f32_smem_bytes(hd) <= fk.MAX_SMEM
    assert fk.f32_smem_bytes(256) == 109568 and fk.f32_smem_bytes(64) == 69632
