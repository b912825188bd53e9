"""The flash-attention backward's two designs (``csrc/flash_attn.cu``,
``flash_bwd_mma_kernel`` for bf16 / fp16 and ``flash_bwd_f32_kernel`` for
f32): their arithmetic emulated in plain PyTorch on the CPU and held against
XLA's gradient of the reference package's ``_mha_blockwise`` (``jax.vjp``)
on the same numpy-made inputs, and their tiles, shared memory and workspace
against the CUDA source (the kernels themselves run in
tests/test_torch_train_cuda.py on the card).

Both designs are emulated tile by tile as the kernels walk them: the dK/dV
kernel keeps a tile of keys (``bwd_rows``, 64 for f32) of one query head
and streams the query tiles that can see them, the dQ kernel keeps 64 query
positions and streams the forward's key range (``bwd_range``); masks only
on edge tiles; P = exp(scale * score (soft-capped) - lse), dS = P (dP - D)
(1 - tanh^2) scale. The bf16 design forms every product as mma.sync does,
f32 sums of 16-element k-steps added one by one to the running f32
accumulator (dK, dV and dQ across the streamed tiles too), with P and dS
rounded to bf16 before the dV, dK and dQ products, and the gradients
rounded once to bf16. The f32 design forms S and dP as 4 x 4 micro-tiles:
per d-split, f32 FMAs left to right over its 16-byte d-chunks, the splits
added as an xor butterfly; the accumulations add the columns of a tile in
the order of P's vectors (e, e + CG, e + 2 CG, e + 3 CG). Both write each
query head's dK / dV as an f32 partial and add a KV row's partials in head
order 0 .. G-1. FMAs are emulated in f64 (the product is exact there) and
rounded to f32.

Inputs are bf16-representable f32 values (so one XLA gradient serves both
designs); the forward's output and log-sum-exp come from the port's plain
forward (the output rounded to bf16 for the bf16 design, as the card's
forward writes it). Tolerances: the card's, 2e-2 of max|ref| for bf16
(``GRAD_TOL`` of tests/test_torch_train_cuda.py) and 1e-4 for f32.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.registry import load_config as jload  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attn as fk  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

TOL = {"bf16": 2e-2, "f32": 1e-4}
SRC = (Path(fk.__file__).resolve().parents[1] / "csrc" / "flash_attn.cu").read_text()

# (name, b, H, KV, s, t, causal, window, softcap): the mask cases of
# tests/test_torch_train_cuda.py CASES at small sizes
CASES = [("causal_g4", 2, 4, 1, 100, 100, True, None, None),
         ("window32_cap50", 1, 4, 2, 130, 130, True, 32, 50.0),
         ("non_causal_g1", 1, 4, 4, 96, 96, False, None, None),
         ("non_causal_t_gt_s_cap30", 1, 4, 2, 40, 70, False, None, 30.0),
         ("window5_narrow", 1, 8, 2, 33, 33, True, 5, None)]


def _fma(a, b, c):
    """a * b + c rounded once to f32 (a * b is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _tree(x):
    """The xor butterfly over the last axis: a pairwise tree in lane order."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _pad(x, n):
    """x's rows (axis 1) zero-filled to n."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[1]))


def _range(dq, r0, rows, cols, s, t, causal, window):
    """The streamed tiles of a CTA (``bwd_range``): their first column and
    count."""
    if dq:
        hi = min(t, r0 + min(rows, s - r0)) if causal else t
        lo = max(0, r0 - window + 1) if window else 0
    else:
        hi = min(s, min(r0 + rows, t) - 1 + window) if window else s
        lo = r0 if causal else 0
    begin = (lo // cols) * cols
    return begin, (-(-(hi - begin) // cols) if hi > begin else 0)


def _visible(qp, kp, s, t, causal, window):
    ok = (kp < t) & (qp < s)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= qp - kp < window
    return ok


def _p_ds(x, y, lse, d, vis, scale, softcap):
    """P and dS from the (unscaled) scores x and dP y, in the kernels' order."""
    x = x * scale
    th = None
    if softcap:
        th = torch.tanh(x / softcap)
        x = softcap * th
    p = torch.where(vis, torch.exp(x - lse), 0.0)
    ds = torch.where(vis, p * (y - d), 0.0)
    if th is not None:
        ds = ds * (1 - th * th)
    return p, ds * scale


def _mma(a, b, acc=None):
    """acc + a (.., m, K) x b (.., n, K)^T as mma.sync adds it: f32 sums of
    each 16-element k-step, added in order to the running f32 accumulator
    (zeros when acc is None)."""
    if acc is None:
        acc = torch.zeros((*a.shape[:-1], b.shape[-2]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 16):
        part = (a[..., k0:k0 + 16].double() @ b[..., k0:k0 + 16].double().transpose(-1, -2))
        acc = acc + part.float()
    return acc


def _micro(a, b, splits):
    """a (.., m, hd) x b (.., n, hd)^T as the f32 kernels form it: per d-split
    FMAs left to right over the split's 16-byte d-chunks, the splits added
    as an xor butterfly."""
    hd = a.shape[-1]
    part = torch.zeros((*a.shape[:-1], b.shape[-2], splits))
    for u in range(hd // 4 // splits):
        for dd in range(4):
            d = 4 * (torch.arange(splits) + splits * u) + dd
            part = _fma(a[..., :, None, d], b[..., None, :, d], part)
    return _tree(part)


def _accumulate(acc, w, c, order):
    """acc (.., m, hd) += w (.., m, n) c (.., n, hd) by FMAs, the columns in
    ``order``."""
    for j in order:
        acc = _fma(w[..., :, j, None], c[..., j, None, :], acc)
    return acc


def emulate_backward(design, q, k, v, out, lse, do, *, group, scale, causal, window, softcap):
    """(dq, dk, dv) of one design on f32 tensors q, do (bh, s, hd), k, v (bkv,
    t, hd), out (bh, s, hd), lse (bh, s): bf16-rounded for "bf16", f32 for
    "f32"."""
    bh, s, hd = q.shape
    t = k.shape[1]
    kk, vv = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    delta = (do * out).sum(-1)          # D: the kernel's butterfly order differs by ulps
    if design == "bf16":
        def rows(dq):
            return fk.bwd_rows(hd, dq)

        def cols(dq):
            return fk.BWD_COLS

        def xy(a1, c1, a2, c2):
            return _mma(a1, c1), _mma(a2, c2)

        def acc(a, w, c):
            return _mma(w.to(torch.bfloat16).float(), c.transpose(-1, -2), a)
    else:
        splits = fk.f32_splits(hd)

        def rows(dq):
            return fk.F32_BQ

        def cols(dq):
            return fk.f32_keys(hd)

        def xy(a1, c1, a2, c2):
            return _micro(a1, c1, splits), _micro(a2, c2, splits)

        def acc(a, w, c):
            cg = w.shape[-1] // 4
            return _accumulate(a, w, c, [e + cg * j for e in range(cg) for j in range(4)])

    # dK / dV: a key tile of each query head, the query tiles streamed
    kr, kc = rows(False), cols(False)
    dk_part, dv_part = torch.zeros((bh, t, hd)), torch.zeros((bh, t, hd))
    for r0 in range(0, t, kr):
        kt, vt = _pad(kk[:, r0:r0 + kr], kr), _pad(vv[:, r0:r0 + kr], kr)
        ak, av = torch.zeros((bh, kr, hd)), torch.zeros((bh, kr, hd))
        begin, n = _range(False, r0, kr, kc, s, t, causal, window)
        kp = torch.arange(r0, r0 + kr)[:, None]
        for c0 in range(begin, begin + n * kc, kc):
            qc, dc = _pad(q[:, c0:c0 + kc], kc), _pad(do[:, c0:c0 + kc], kc)
            lc = torch.nn.functional.pad(lse[:, c0:c0 + kc], (0, kc - lse[:, c0:c0 + kc].shape[1]))
            dl = torch.nn.functional.pad(delta[:, c0:c0 + kc],
                                         (0, kc - delta[:, c0:c0 + kc].shape[1]))
            x, y = xy(kt, qc, vt, dc)
            qp = torch.arange(c0, c0 + kc)[None, :]
            p, ds = _p_ds(x, y, lc[:, None, :], dl[:, None, :],
                          _visible(qp, kp, s, t, causal, window), scale, softcap)
            av, ak = acc(av, p, dc), acc(ak, ds, qc)
        n_valid = min(kr, t - r0)
        dk_part[:, r0:r0 + n_valid], dv_part[:, r0:r0 + n_valid] = ak[:, :n_valid], av[:, :n_valid]
    # the group sum: each KV row's partials in head order, from 0
    bkv = bh // group
    dk, dv = torch.zeros((bkv, t, hd)), torch.zeros((bkv, t, hd))
    for g in range(group):
        dk, dv = dk + dk_part[g::group], dv + dv_part[g::group]
    # dQ: 64 query positions of each head, the key tiles streamed
    qr, qc_n = rows(True), cols(True)
    dq = torch.zeros((bh, s, hd))
    for r0 in range(0, s, qr):
        qt, dt = _pad(q[:, r0:r0 + qr], qr), _pad(do[:, r0:r0 + qr], qr)
        lr = torch.nn.functional.pad(lse[:, r0:r0 + qr], (0, qr - lse[:, r0:r0 + qr].shape[1]))
        dl = torch.nn.functional.pad(delta[:, r0:r0 + qr],
                                     (0, qr - delta[:, r0:r0 + qr].shape[1]))
        aq = torch.zeros((bh, qr, hd))
        begin, n = _range(True, r0, qr, qc_n, s, t, causal, window)
        qp = torch.arange(r0, r0 + qr)[:, None]
        for c0 in range(begin, begin + n * qc_n, qc_n):
            kc_t, vc_t = _pad(kk[:, c0:c0 + qc_n], qc_n), _pad(vv[:, c0:c0 + qc_n], qc_n)
            x, y = xy(qt, kc_t, dt, vc_t)
            kp = torch.arange(c0, c0 + qc_n)[None, :]
            _, ds = _p_ds(x, y, lr[:, :, None], dl[:, :, None],
                          _visible(qp, kp, s, t, causal, window), scale, softcap)
            aq = acc(aq, ds, kc_t)
        n_valid = min(qr, s - r0)
        dq[:, r0:r0 + n_valid] = aq[:, :n_valid]
    if design == "bf16":
        return tuple(x.to(torch.bfloat16).float() for x in (dq, dk, dv))
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _case(name: str, hd: int):
    """Inputs in the kernel's layout and XLA's gradient of _mha_blockwise
    (b*H, s, hd) / (b*KV, t, hd) on them."""
    _, b, h, kv, s, t, causal, window, cap = next(c for c in CASES if c[0] == name)
    rng = np.random.default_rng(hd + s + t)

    def bf16(shape):   # bf16-representable values
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, do = bf16((b, s, h, hd)), bf16((b, s, h * hd))
    k, v = bf16((b, t, kv, hd)), bf16((b, t, kv, hd))
    jcfg = dataclasses.replace(jload("tinyllama-1.1b").reduced(), num_heads=h, num_kv_heads=kv,
                               head_dim=hd, attn_logit_softcap=cap, query_scale=None)

    def f(q_, k_, v_):
        return jattn._mha_blockwise(q_, k_, v_, jcfg, causal=causal, window=window)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gq, gk, gv = (np.asarray(g) for g in vjp(jnp.asarray(do)))

    def heads(x):      # (b, n, heads, hd) -> (b*heads, n, hd)
        return torch.from_numpy(np.array(x.transpose(0, 2, 1, 3).reshape(
            -1, x.shape[1], hd)))

    inputs = (heads(q), heads(k), heads(v), heads(do.reshape(b, s, h, hd)))
    want = tuple(heads(g) for g in (gq, gk, gv))
    kw = dict(group=h // kv, scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    return inputs, want, kw


@pytest.mark.parametrize("design", ["bf16", "f32"])
@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_backward_design_within_tolerance_of_xla_gradient(case, hd, design):
    (q, k, v, do), want, kw = _case(case, hd)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    if design == "bf16":
        out = out.to(torch.bfloat16).float()
    got = emulate_backward(design, q, k, v, out, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        err = ((g - w).abs().max() / w.abs().max()).item()
        assert np.isfinite(g.numpy()).all() and err <= TOL[design], (name, err)


def _cuda_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_backward_tiles_smem_and_workspace_mirror_the_cuda_source():
    """The backward's tile functions in csrc/flash_attn.cu are those that
    kernels/flash_attn.py mirrors; its shared memory, region by region, is
    bwd_smem_bytes and fits the 232,448 bytes a block may opt into at every
    head dim (two f32 CTAs an SM at hd 32 and 64, with the 1 KB the card
    reserves a block); the workspace is two f32 (b*H, t, hd) arrays for GQA
    and none for group 1."""
    assert _cuda_int("kBwdThreads") == fk.BWD_THREADS
    assert _cuda_int("kBwdCols") == fk.BWD_COLS
    assert "return !kDQ && HD > 128 ? 2 : 1;" in SRC
    assert "return 16 * (kBwdThreads / 32) / bwd_dsplit<HD, kDQ>();" in SRC
    assert "return HD < 64 || HD % 64 == 0 ? HD : (HD + 63) / 64 * 64;" in SRC
    assert re.search(r"return 2 \* \(2 \* \(size_t\)bwd_rows<HD, kDQ>\(\) \* row_elems<HD>\(\) \+"
                     r"\s+2 \* \(size_t\)kStages \* kBwdCols \* row_elems<HD>\(\)\) \+"
                     r"\s+\(kDQ \? 0 : sizeof\(float\) \* 2 \* \(size_t\)kStages \* kBwdCols\);",
                     SRC)
    assert re.search(r"return sizeof\(float\) \* \(2 \* \(size_t\)kF32BQ \* "
                     r"f32_row_floats<HD>\(\) \+"
                     r"\s+2 \* \(size_t\)f32_keys<HD>\(\) \* f32_row_floats<HD>\(\) \+"
                     r"\s+\(kDQ \? 1 : 2\) \* \(size_t\)kF32BQ \* \(f32_keys<HD>\(\) \+ 4\) \+"
                     r"\s+\(kDQ \? 0 : 2 \* \(size_t\)f32_keys<HD>\(\)\)\);", SRC)
    assert "__launch_bounds__(kF32Threads, HD <= 64 ? 2 : 1)" in SRC
    assert _cuda_int("kStages") == 2
    for hd in fk.HEAD_DIMS:
        for dq in (False, True):
            rows, cols, row = fk.bwd_rows(hd, dq), fk.BWD_COLS, fk.row_elems(hd)
            # 16 rows a warp; the columns fill whole mma k-steps
            assert rows * fk.bwd_dsplit(hd, dq) == 16 * fk.BWD_THREADS // 32 and cols % 16 == 0
            assert (hd // fk.bwd_dsplit(hd, dq)) % 16 == 0 and row % 8 == 0 and row >= hd
            regions = [2 * rows * row, 2 * rows * row, 2 * 2 * cols * row, 2 * 2 * cols * row]
            regions += [] if dq else [4 * 2 * cols, 4 * 2 * cols]
            assert fk.bwd_smem_bytes(hd, dq) == sum(regions) <= fk.MAX_SMEM
            assert all(r % 16 == 0 for r in regions)
            f32 = fk.bwd_smem_bytes(hd, dq, torch.float32)
            assert f32 <= fk.MAX_SMEM
            if hd <= 64:
                assert 2 * (f32 + 1024) <= 228 * 1024
        assert fk.bwd_workspace_bytes(32, 2048, hd, 1) == 0
        assert fk.bwd_workspace_bytes(32, 2048, hd, 8) == 2 * 32 * 2048 * hd * 4
    assert fk.bwd_workspace_bytes(32, 2048, 64, 8) == 33554432
    assert fk.bwd_smem_bytes(256, True) == 131072 and fk.bwd_smem_bytes(64, False) == 33280
    assert fk.bwd_smem_bytes(256, False, torch.float32) == 184448
