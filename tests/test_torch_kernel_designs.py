"""The arithmetic of the redesigned CUDA kernels, emulated in plain PyTorch
on the CPU and held against the reference package (the CUDA kernels
themselves run in tests/test_torch_cuda.py on the card).

- Paged decode attention (``csrc/paged_attn.cu``): split-K. The columns of
  each row are cut into S runs of whole tiles (64 columns of whole blocks);
  each run keeps its own running max m, denominator l and unnormalised
  accumulator over its tiles (a tile whose blocks are all masked is
  skipped, as the kernel skips it), and a combine weighs the runs by
  e^(m_s - m). Held to the port's plain version, the reference's oracle
  and its Pallas kernel in interpret mode within 1e-5 * max|ref| in f32
  (another f32 summation order).
- The wrapper's split plan and shared-memory sizing, which mirror the CUDA
  source.
- Flash attention on the tensor cores (``csrc/flash_attn.cu``): the online
  softmax over 64-key tiles (32 at hd 256) with the weights P rounded to
  bf16 before P V
  and the output rounded to bf16, held to the reference's
  ``flash_attention_pallas`` (interpret mode) on the same bf16 values within
  1e-2 * max|ref|: the tolerance the card holds the kernel to.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_pallas  # noqa: E402
from repro.kernels.paged_attn import paged_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attn as flash_kern  # noqa: E402
from repro_torch.kernels import paged_attn as paged_kern  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

CSRC = Path(paged_kern.__file__).resolve().parents[1] / "csrc"
NEG_INF, DEAD = -1e30, -1e29


# ---------------------------------------------------------------------------
# paged decode attention: split-K emulation
# ---------------------------------------------------------------------------

def _split_paged(q, k_pages, v_pages, table, pos, k_new, v_new, mask, *, scale, softcap,
                 k_scales, v_scales, splits):
    """The kernel's two passes in plain f32: pass 1 per (row, KV head, split)
    over its tiles with an online softmax, pass 2 the combine. Returns
    (ctx (b, KV * G * hd), the plan (S, tiles per split))."""
    b, kv, g, hd = q.shape
    bs, mb = k_pages.shape[1], table.shape[1]
    tb = paged_kern.tile_blocks(bs)
    ntiles = -(-mb // tb)
    tps = -(-ntiles // splits)
    nsplit = -(-ntiles // tps)
    out = torch.empty((b, kv, g, hd))
    for i in range(b):
        p = int(pos[i])
        for k in range(kv):
            parts = []
            for sp in range(nsplit):
                m = torch.full((g,), NEG_INF)
                l = torch.zeros(g)
                acc = torch.zeros((g, hd))
                for tt in range(sp * tps, min(ntiles, (sp + 1) * tps)):
                    j0, c0 = tt * tb, tt * tb * bs
                    nblk = min(tb, mb - j0)
                    cols = torch.arange(c0, c0 + nblk * bs)
                    mk = mask[i, cols]
                    live = (mk.reshape(nblk, bs) > DEAD).any(1).repeat_interleave(bs)
                    if not live.any():
                        continue                      # a dead tile is skipped
                    phys = table[i, j0:j0 + nblk].long().clamp(0, k_pages.shape[0] - 1)
                    kk = k_pages[phys, :, k].reshape(-1, hd).float()
                    vv = v_pages[phys, :, k].reshape(-1, hd).float()
                    if k_scales is not None:
                        kk = kk * k_scales[phys, :, k].reshape(-1, 1)
                        vv = vv * v_scales[phys, :, k].reshape(-1, 1)
                    cur = (cols == p) & live
                    kk[cur], vv[cur] = k_new[i, k].float(), v_new[i, k].float()
                    vv[~live] = 0.0
                    s = q[i, k].float() @ kk.T * scale
                    if softcap:
                        s = softcap * torch.tanh(s / softcap)
                    s = torch.where(live[None], s + mk[None], torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max(1).values)
                    w = torch.exp(s - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + w.sum(1)
                    acc = acc * alpha[:, None] + w @ vv
                    m = m_new
                parts.append((m, l, acc))
            ms = torch.stack([pt[0] for pt in parts])            # (S, G)
            mx = ms.max(0).values
            wts = torch.exp(ms - mx)
            num = sum(wts[s, :, None] * parts[s][2] for s in range(len(parts)))
            den = sum(wts[s] * parts[s][1] for s in range(len(parts)))
            out[i, k] = num / torch.clamp(den, min=1e-30)[:, None]
    return out.reshape(b, kv * g * hd), (nsplit, tps)


def _inputs(pool, seed, *, b=3, kv=2, g=4, hd=16, bs=64, mb=6, positions=None):
    """Random pool (float or int8/fp8 with row scales), a non-identity table
    whose entries past each row's position point at the sink block 0,
    positions and the decode mask: numpy, for both packages."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    shape = (nb, bs, kv, hd)
    pos = rng.integers(0, mb * bs, size=(b,)) if positions is None else np.asarray(positions)
    table = (rng.permutation(nb - 1)[: b * mb] + 1).reshape(b, mb)
    table = np.where(np.arange(mb)[None, :] > pos[:, None] // bs, 0, table).astype(np.int32)
    a = dict(q=rng.normal(size=(b, kv, g, hd)).astype(np.float32),
             k_new=rng.normal(size=(b, kv, hd)).astype(np.float32),
             v_new=rng.normal(size=(b, kv, hd)).astype(np.float32), pos=pos, table=table,
             mask=np.where(np.arange(mb * bs)[None, :] <= pos[:, None], 0.0, -1e30)
             .astype(np.float32))
    if pool == "float":
        a["k_pages"], a["v_pages"] = (rng.normal(size=shape).astype(np.float32)
                                      for _ in range(2))
    else:
        jdt = jnp.int8 if pool == "int8" else jnp.float8_e4m3fn
        for name in ("k", "v"):
            vals = rng.normal(size=shape) * (40 if pool == "int8" else 100)
            vals = np.clip(np.round(vals) if pool == "int8" else vals, -127, 127)
            a[f"{name}_pages"] = np.asarray(jnp.asarray(vals, jnp.float32).astype(jdt))
            a[f"{name}_scales"] = rng.uniform(1e-3, 2e-2, size=shape[:-1]).astype(np.float32)
    return a


def _torch(x):
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(np.array(x).view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(x))


def _call(fn, a, to, **kw):
    quant = "k_scales" in a
    return fn(to(a["q"]), to(a["k_pages"]), to(a["v_pages"]), to(a["table"]), to(a["pos"]),
              to(a["k_new"]), to(a["v_new"]), to(a["mask"]),
              k_scales=to(a["k_scales"]) if quant else None,
              v_scales=to(a["v_scales"]) if quant else None, **kw)


@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6])
def test_split_k_paged_emulation_matches_reference(pool, splits, softcap):
    """Blocks of 64 rows: one block a tile, so MB = 6 tiles and S runs from 1
    to MB (S = 4 leaves tiles per split 2, 2, 2: the plan's own rounding;
    S = 3 and 6 split evenly, S = 2 into 3 + 3)."""
    a = _inputs(pool, seed=splits * 7 + (softcap is not None))
    kw = dict(scale=0.25, softcap=softcap)
    got, plan = _call(_split_paged, a, _torch, splits=splits, **kw)
    want = _call(ref.paged_attention_ref, a, _torch, **kw)
    oracle = np.asarray(_call(jref.paged_attention_ref, a, jnp.asarray, **kw))
    pallas = np.asarray(_call(paged_attention_pallas, a, jnp.asarray, interpret=True, **kw))
    assert plan[0] == min(splits, 6) - (splits == 4)
    tol = 1e-5 * np.abs(oracle).max()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
def test_split_k_paged_emulation_with_dead_splits(pool):
    """Positions in the first tile: every later split has only masked
    columns (m = -1e30, l = 0, acc = 0) and the combine weighs it by 0."""
    a = _inputs(pool, seed=31, positions=[0, 17, 63])
    kw = dict(scale=0.25, softcap=None)
    got, plan = _call(_split_paged, a, _torch, splits=6, **kw)
    assert plan == (6, 1)
    oracle = np.asarray(_call(jref.paged_attention_ref, a, jnp.asarray, **kw))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5 * np.abs(oracle).max())


@pytest.mark.parametrize("bs,mb,splits", [(8, 40, 2), (16, 18, 3), (64, 5, 2)])
def test_split_k_paged_emulation_ragged_last_split(bs, mb, splits):
    """A last tile of fewer blocks (40 blocks of 8 = 5 tiles of 8 blocks;
    18 of 16 = 4 + 4 + 4 + 4 + 2) and a last split of fewer tiles."""
    a = _inputs("int8", seed=bs + mb, bs=bs, mb=mb, positions=[mb * bs - 1, mb * bs // 2, 5])
    kw = dict(scale=0.25, softcap=30.0)
    got, (nsplit, tps) = _call(_split_paged, a, _torch, splits=splits, **kw)
    assert nsplit * tps > -(-mb // paged_kern.tile_blocks(bs))     # the last split is short
    oracle = np.asarray(_call(jref.paged_attention_ref, a, jnp.asarray, **kw))
    pallas = np.asarray(_call(paged_attention_pallas, a, jnp.asarray, interpret=True, **kw))
    tol = 1e-5 * np.abs(oracle).max()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=tol)


# ---------------------------------------------------------------------------
# the wrapper's split plan and shared-memory sizing
# ---------------------------------------------------------------------------

def _cuda_constants() -> dict[str, int]:
    src = (CSRC / "paged_attn.cu").read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}


def test_split_plan_constants_mirror_the_cuda_source():
    c = _cuda_constants()
    assert c["kThreads"] == paged_kern.THREADS and c["kTileCols"] == paged_kern.TILE_COLS
    assert c["kMaxOut"] == paged_kern.MAX_OUT
    assert c["kMaxSmem"] == paged_kern.MAX_SMEM and c["kMaxSplits"] == paged_kern.MAX_SPLITS
    assert c["kStages"] == paged_kern.STAGES and c["kSlots"] == paged_kern.SLOTS


def test_split_plan_covers_every_tile_once():
    for b, kv, mb, bs in itertools.product((1, 3, 8, 32, 300), (1, 4), (1, 4, 7, 32, 256, 1000),
                                           (8, 16, 24, 64, 128)):
        nsplit, tps = paged_kern.split_plan(b, kv, mb, bs)
        ntiles = -(-mb // paged_kern.tile_blocks(bs))
        assert 1 <= nsplit <= min(ntiles, paged_kern.MAX_SPLITS) and tps >= 1
        assert (nsplit - 1) * tps < ntiles <= nsplit * tps      # no empty split
        # splits only while the grid is below the target of CTAs, and two
        # tiles a split or more once a row has PAIR_FROM tiles
        if nsplit > 1:
            assert b * kv * (nsplit - 1) < paged_kern.SMS * paged_kern.CTAS_PER_SM
        if ntiles >= paged_kern.PAIR_FROM:
            assert tps >= 2


def test_split_plan_depends_on_shapes_only():
    """The plan is a pure function of (b, KV, MB, BS) and the tile width: no
    positions, no mask, so the wrapper never reads the card to choose it.
    The golden ragged
    trace's shape (3 slots, 4 KV heads, a 32-token cache in blocks of 8)
    runs one split, which keeps the first design's order of arithmetic; the
    ragged serve's (8 slots, 256 tokens in blocks of 8) runs one split per
    tile; a 2048-token cache at 32 rows runs 8 splits of 4 tiles, at 8 rows
    16 splits of 2."""
    import inspect

    # cols, the tile's width, is tile_cols of the pool's row shape
    assert list(inspect.signature(paged_kern.split_plan).parameters) == ["b", "kv", "mb", "bs",
                                                                         "cols"]
    assert paged_kern.split_plan(3, 4, 32 // 8, 8) == (1, 1)
    assert paged_kern.split_plan(8, 4, 256 // 8, 8) == (4, 1)
    assert paged_kern.split_plan(32, 4, 2048 // 8, 8) == (8, 4)
    assert paged_kern.split_plan(8, 4, 2048 // 8, 8) == (16, 2)


@pytest.mark.parametrize("g,hd,bs,elt,quant", [(8, 64, 8, 2, False), (8, 64, 16, 1, True),
                                               (8, 64, 8, 4, False), (2, 32, 8, 4, False),
                                               (4, 128, 128, 2, False), (8, 64, 24, 1, True)])
def test_paged_smem_bytes_mirror_the_layout(g, hd, bs, elt, quant):
    """The layout of csrc/paged_attn.cu, summed region by region: three
    stages of K and V rows (and f32 scales for a quantized pool), q,
    k_new, v_new, scores, alpha / l / m, five slots of mask values and table
    entries, three stages of row offsets."""
    tb = paged_kern.tile_blocks(bs)
    tc = tb * bs
    row = hd * elt
    regions = [3 * 2 * tc * row, (3 * 2 * tc * 4) if quant else 0, 4 * g * hd, 4 * 2 * hd,
               4 * g * tc, 4 * 3 * g, 4 * 5 * tc, 4 * 5 * tb, 4 * 3 * tc]
    assert paged_kern.smem_bytes(g, hd, bs, elt, quant) == sum(regions)
    assert row % 16 == 0 and sum(regions[:2]) % 16 == 0    # 16-byte copies stay aligned


# the families' paged shapes (KV, G, hd): deepseek-coder-33b's 8 / 7,
# internlm2-1.8b's 8 / 2 and pixtral-12b's 8 / 4 at hd 128, gemma2-2b's 4 / 2
# at hd 256
FAMILY_PAGED = [(8, 7, 128), (8, 2, 128), (8, 4, 128), (4, 2, 256)]


@pytest.mark.parametrize("kv,g,hd", FAMILY_PAGED)
def test_paged_plan_and_smem_at_the_families_shapes(kv, g, hd):
    """Every pool type (bf16, f32, int8/fp8 bytes) at blocks of 8 and 16 fits
    the shared memory, G * hd fits the CTA's outputs, and the split plan
    covers every tile once at b 1-32 over 256-4608-token tables."""
    assert hd in paged_kern.HEAD_DIMS and g * hd <= paged_kern.MAX_OUT * paged_kern.THREADS
    for (elt, quant), bs in itertools.product(((2, False), (4, False), (1, True)), (8, 16)):
        assert paged_kern.smem_bytes(g, hd, bs, elt, quant) <= paged_kern.MAX_SMEM
        cols = paged_kern.tile_cols(hd, elt)
        for b, t in itertools.product((1, 3, 8, 32), (256, 2048, 4608)):
            mb = t // bs
            nsplit, tps = paged_kern.split_plan(b, kv, mb, bs, cols)
            ntiles = -(-mb // paged_kern.tile_blocks(bs, cols))
            assert (nsplit - 1) * tps < ntiles <= nsplit * tps


@pytest.mark.parametrize("pool", ["float", "int8"])
@pytest.mark.parametrize("g,hd,window,softcap", [(7, 128, None, None), (2, 256, 40, 50.0)],
                         ids=["deepseek_g7_hd128", "gemma2_hd256_window_cap"])
def test_split_k_paged_emulation_at_the_families_heads(pool, g, hd, window, softcap):
    """The split kernel's two passes at deepseek-coder's G 7 (hd 128) and at
    gemma2's hd 256 with a window mask (positions past it, so whole tiles
    are masked and skipped) and soft cap, against the reference's oracle
    and its Pallas kernel interpreted."""
    a = _inputs(pool, seed=g * hd, b=3, kv=2, g=g, hd=hd, bs=8, mb=24,
                positions=[191, 120, 57])
    if window is not None:
        cols = np.arange(a["mask"].shape[1])[None, :]
        pos = a["pos"][:, None]
        a["mask"] = np.where((cols <= pos) & (pos - cols < window), 0.0, -1e30
                             ).astype(np.float32)
    kw = dict(scale=hd ** -0.5, softcap=softcap)
    got, plan = _call(_split_paged, a, _torch, splits=3, **kw)
    assert plan == (3, 1)
    oracle = np.asarray(_call(jref.paged_attention_ref, a, jnp.asarray, **kw))
    pallas = np.asarray(_call(paged_attention_pallas, a, jnp.asarray, interpret=True, **kw))
    tol = 1e-5 * np.abs(oracle).max()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=tol)


# ---------------------------------------------------------------------------
# flash attention on the tensor cores: bf16 P
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _flash_mma(q, k, v, *, group, scale, causal=True, window=None, softcap=None):
    """The tensor-core kernel's arithmetic: 64 query rows x K/V tiles of
    ``flash_attn.kv_tile(hd)`` keys, S = q k^T in f32 from bf16 inputs,
    scale / soft cap / masks (keys past t at -inf, masked keys at -1e30,
    tiles above the diagonal or wholly outside the window skipped), online
    softmax in f32, P rounded to bf16 before P V, l summing the f32 weights,
    the output rounded to bf16."""
    bh, s, hd = q.shape
    t = k.shape[1]
    bk = flash_kern.kv_tile(hd)
    out = torch.empty_like(q)
    for row in range(bh):
        kr, vr = k[row // group], v[row // group]
        for q0 in range(0, s, 64):
            qt = q[row, q0:q0 + 64]
            nq = qt.shape[0]
            k_end = min(t, q0 + nq) if causal else t
            k_begin = (max(0, q0 - window + 1) // bk) * bk if window else 0
            m = torch.full((nq,), NEG_INF)
            l = torch.zeros(nq)
            acc = torch.zeros((nq, hd))
            qp = torch.arange(q0, q0 + nq)[:, None]
            for k0 in range(k_begin, k_end, bk):
                kt, vt = kr[k0:k0 + bk], vr[k0:k0 + bk]
                sc = qt @ kt.T * scale
                if softcap:
                    sc = softcap * torch.tanh(sc / softcap)
                kp = torch.arange(k0, k0 + kt.shape[0])[None, :]
                ok = torch.ones_like(sc, dtype=torch.bool)
                if causal:
                    ok &= kp <= qp
                if window:
                    ok &= (qp - kp) < window
                sc = torch.where(ok, sc, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, sc.max(1).values)
                w = torch.exp(sc - m_new[:, None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + w.sum(1)
                acc = acc * alpha[:, None] + _bf16(w) @ vt
                m = m_new
            out[row, q0:q0 + nq] = acc / torch.clamp(l, min=1e-30)[:, None]
    return _bf16(out)


@pytest.mark.parametrize("case", ["tinyllama", "window_softcap", "ragged", "gemma2_hd256",
                                  "zamba2_hd112"])
def test_flash_bf16_p_emulation_within_tolerance_of_pallas(case):
    """TinyLlama's head layout (32 query / 4 KV heads, hd 64) over a 256-token
    causal prompt; a window of 48 with a soft cap of 50; s = t = 200 (a
    ragged last tile); gemma2's 8 / 4 heads at hd 256 (32-key tiles) with a
    window of 48 and a soft cap of 50 over 200 tokens; zamba2's shared
    attention, hd 112 with as many KV heads as query heads. Inputs rounded
    to bf16 for both."""
    bh, bkv, s, hd, kw = {
        "tinyllama": (32, 4, 256, 64, {}),
        "window_softcap": (8, 2, 256, 64, dict(window=48, softcap=50.0)),
        "ragged": (8, 2, 200, 64, {}),
        "gemma2_hd256": (8, 4, 200, 256, dict(window=48, softcap=50.0)),
        "zamba2_hd112": (4, 4, 136, 112, {}),
    }[case]
    rng = np.random.default_rng(hd + s + len(kw))
    arrays = [_bf16(torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
              for shape in ((bh, s, hd), (bkv, s, hd), (bkv, s, hd))]
    kw = dict(group=bh // bkv, scale=hd ** -0.5, **kw)
    got = _flash_mma(*arrays, **kw)
    want = np.asarray(flash_attention_pallas(*(jnp.asarray(a.numpy()) for a in arrays),
                                             interpret=True, **kw))
    err = np.abs(got.numpy() - want).max()
    assert np.isfinite(got.numpy()).all() and err <= 1e-2 * np.abs(want).max(), err


def test_flash_head_dims_and_tiles_mirror_the_cuda_source():
    """Both flash kernels are built for every head dim the wrapper takes, and
    the emulation's K/V tile is the kernel's (32 keys at hd 256, else 64)."""
    src = (Path(flash_kern.__file__).resolve().parents[1] / "csrc" / "flash_attn.cu").read_text()
    macro = re.search(r"#define FLASH_HEAD_DIMS\(X\) (.*)", src).group(1)
    assert tuple(int(h) for h in re.findall(r"X\((\d+)\)", macro)) == flash_kern.HEAD_DIMS
    assert "return HD > 128 ? 32 : 64;" in src
    assert [flash_kern.kv_tile(h) for h in flash_kern.HEAD_DIMS] == [64, 64, 64, 64, 32]
