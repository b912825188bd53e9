"""Plain PyTorch versions of the port's CUDA kernels.

Counterpart of ``repro/kernels/ref.py`` (``gqmv_ref``, ``gqmm_ref``, their
int4/int3/fp8 siblings, ``paged_attention_ref``), of the reference's
oracles for its flash-attention and fused RMSNorm + quantize kernels
(``flash_attention_ref``, ``rmsnorm_quant_ref``), and the yardstick the CUDA
kernels in ``csrc/`` are held to; also the sanitizer's use-after-free
oracle, ``paged_poison_counts``. GQMV/GQMM (paper Algorithm 1,
``csrc/gqmm.cu``):

  for each output row i:
    for each group j (of GS columns):
      group_sum = sum_k  xq[j*GS+k] * wq[i, j*GS+k]        # exact integer
      out[i]   += scaled(group_sum, ws[i, j], xs[j])       # f32

The group sums are formed in f32, on the CPU and on the card alike: every
product is at most 127^2 and every partial sum at most 127^2 * 256 < 2^24,
so each is an integer f32 holds exactly, in any summation order (and TF32,
whose 10-bit mantissa holds int8 values exactly, would not change them
either; callers that time it still turn TF32 off). ``torch.matmul`` has no
int32 kernel on CUDA, which is why the reference's int32 einsum becomes an
f32 one here. The f32 scaling keeps the oracle's association,
``(group_sums * ws) * xs``, for both shapes.

The int4 and int3 versions unpack the weights to int8 values first (their
group sums are exact too, |w| <= 7). They keep the reference oracles' own
association, which is not int8's: ``group_sums * (ws * xs)`` for GQMV and
``(group_sums * xs) * ws`` for GQMM. fp8 weights are cast to f32 and the
group dots run in f32, so their group sums are rounded (not exact) and the
kernel is held to them by a tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.core import flags
from repro_torch.core.quant import quantize_groupwise, unpack_int3, unpack_int4
from repro_torch.models.common import NEG_INF, rmsnorm


def gqmv_ref(
    wq: torch.Tensor,   # int8 (m, n)
    ws: torch.Tensor,   # float32 (m, n // GS)
    xq: torch.Tensor,   # int8 (n,)
    xs: torch.Tensor,   # float32 (n // GS,)
    *,
    group_size: int,
) -> torch.Tensor:
    """out[m] = GQMV(W, x) per paper Alg. 1. Returns float32 (m,)."""
    m, n = wq.shape
    ng = n // group_size
    wg = wq.reshape(m, ng, group_size).to(torch.float32)
    xg = xq.reshape(ng, group_size).to(torch.float32)
    group_sums = torch.einsum("mgk,gk->mg", wg, xg)             # exact (m, ng)
    scaled = group_sums * ws * xs[None, :]
    return scaled.sum(dim=-1)


def gqmm_ref(
    wq: torch.Tensor,   # int8 (m, n)
    ws: torch.Tensor,   # float32 (m, n // GS)
    xq: torch.Tensor,   # int8 (b, n)
    xs: torch.Tensor,   # float32 (b, n // GS)
    *,
    group_size: int,
) -> torch.Tensor:
    """Batched GQMV: out[b, m]. Returns float32 (b, m)."""
    m, n = wq.shape
    b = xq.shape[0]
    ng = n // group_size
    wg = wq.reshape(m, ng, group_size).to(torch.float32)
    xg = xq.reshape(b, ng, group_size).to(torch.float32)
    group_sums = torch.einsum("mgk,bgk->bmg", wg, xg)           # exact (b, m, ng)
    scaled = group_sums * ws[None] * xs[:, None, :]
    return scaled.sum(dim=-1)


def _group_sums_mv(wv: torch.Tensor, xq: torch.Tensor, group_size: int) -> torch.Tensor:
    """(m, ng) f32 group dots of logical weight values (m, n) and x (n,)."""
    m, n = wv.shape
    ng = n // group_size
    return torch.einsum("mgk,gk->mg", wv.reshape(m, ng, group_size).to(torch.float32),
                        xq.reshape(ng, group_size).to(torch.float32))


def _group_sums_mm(wv: torch.Tensor, xq: torch.Tensor, group_size: int) -> torch.Tensor:
    """(b, m, ng) f32 group dots of logical weight values (m, n) and x (b, n)."""
    m, n = wv.shape
    ng = n // group_size
    return torch.einsum("mgk,bgk->bmg", wv.reshape(m, ng, group_size).to(torch.float32),
                        xq.reshape(xq.shape[0], ng, group_size).to(torch.float32))


def _gqmv_combined(wv, ws, xq, xs, group_size: int) -> torch.Tensor:
    return (_group_sums_mv(wv, xq, group_size) * (ws * xs[None, :])).sum(dim=-1)


def _gqmm_xs_first(wv, ws, xq, xs, group_size: int) -> torch.Tensor:
    return ((_group_sums_mm(wv, xq, group_size) * xs[:, None, :]) * ws[None]).sum(dim=-1)


def gqmv_int4_ref(wp, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """Packed-int4 GQMV: wp int8 (m, n // 2), two nibbles per byte. (m,) f32."""
    return _gqmv_combined(unpack_int4(wp), ws, xq, xs, group_size)


def gqmm_int4_ref(wp, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """Packed-int4 GQMM: xq (b, n). Returns (b, m) f32."""
    return _gqmm_xs_first(unpack_int4(wp), ws, xq, xs, group_size)


def gqmv_int3_ref(wp, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """Packed-int3 GQMV: wp uint8 (m, n // 8 * 3), eight 3-bit fields per
    three bytes. Returns (m,) f32."""
    return _gqmv_combined(unpack_int3(wp), ws, xq, xs, group_size)


def gqmm_int3_ref(wp, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """Packed-int3 GQMM: xq (b, n). Returns (b, m) f32."""
    return _gqmm_xs_first(unpack_int3(wp), ws, xq, xs, group_size)


def gqmv_fp8_ref(wq, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """fp8-weight GQMV: wq float8_e4m3fn (m, n), group dots in f32. (m,) f32."""
    return _gqmv_combined(wq, ws, xq, xs, group_size)


def gqmm_fp8_ref(wq, ws, xq, xs, *, group_size: int) -> torch.Tensor:
    """fp8-weight GQMM: xq (b, n). Returns (b, m) f32."""
    return _gqmm_xs_first(wq, ws, xq, xs, group_size)


def paged_attention_ref(
    q: torch.Tensor,            # (b, KV, G, hd) decode-step queries, grouped
    k_pages: torch.Tensor,      # (NB, BS, KV, hd) one layer's block pool
    v_pages: torch.Tensor,      # (NB, BS, KV, hd)
    block_table: torch.Tensor,  # (b, MB) physical block per virtual block
    pos: torch.Tensor,          # (b,) current decode position per row
    k_new: torch.Tensor,        # (b, KV, hd) current token's K (not yet committed)
    v_new: torch.Tensor,        # (b, KV, hd)
    mask: torch.Tensor,         # (b, T) additive decode mask, T = MB * BS
    *,
    scale: float,
    softcap: float | None = None,
    k_scales: torch.Tensor | None = None,   # (NB, BS, KV) quantized-pool scales
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the paged decode-attention kernel (``csrc/paged_attn.cu``),
    the reference's ``paged_attention_ref`` op for op.

    Row i's keys live in pool blocks ``block_table[i]``: virtual position t
    maps to slot ``(block_table[i, t // BS], t % BS)``. The gathered virtual
    sequence is attended with the current token handled explicitly: its
    score overwrites column ``pos``, and its value is added after the
    attention weight at ``pos`` is zeroed, so stale rows in recycled or sink
    blocks never contribute (every other unwritten column is masked).

    With ``k_scales``/``v_scales`` the pool holds int8/fp8 rows with one f32
    scale per (block row, kv head), factored outside the dots as in the
    reference: ``(q . k_q) * k_s`` and ``(attn * v_s) . v_q``.

    Returns ctx (b, KV * G * hd) in ``q``'s dtype.
    """
    b, kv, g, hd = q.shape
    bs = k_pages.shape[1]
    mb = block_table.shape[1]
    table = block_table.long()
    pos = pos.long()
    k = k_pages[table].reshape(b, mb * bs, kv, hd)
    v = v_pages[table].reshape(b, mb * bs, kv, hd)
    quant = k_scales is not None
    if quant:
        k = k.to(q.dtype)
        ks = k_scales[table].reshape(b, mb * bs, kv)              # (b, T, KV)
        vs = v_scales[table].reshape(b, mb * bs, kv)
    scores = torch.einsum("bkgh,btkh->bkgt", q, k).to(torch.float32)
    if quant:
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]      # (b, KV, 1, T)
    cur = torch.einsum("bkgh,bkh->bkg", q, k_new).to(torch.float32)
    rows = torch.arange(b, device=q.device)
    scores[rows, :, :, pos] = cur
    scores = scores * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + mask[:, None, None, :]
    attn = torch.softmax(scores, dim=-1)
    attn_cur = attn[rows, :, :, pos][..., None].to(q.dtype)       # (b, KV, G, 1)
    attn_z = attn.clone()
    # a device zero: a Python scalar would be copied from the host, which a
    # captured program (serving/graphs.py) cannot record
    attn_z[rows, :, :, pos] = attn_z.new_zeros(())
    if quant:
        attn_z = attn_z * vs.permute(0, 2, 1)[:, :, None, :]
        v = v.to(q.dtype)
    ctx = torch.einsum("bkgt,btkh->bkgh", attn_z.to(q.dtype), v)
    ctx = ctx + attn_cur * v_new[:, :, None, :]
    return ctx.reshape(b, kv * g * hd)


def paged_poison_counts(
    k_pages: torch.Tensor,      # (L, NB, BS, KV, hd) the block pool, every layer
    v_pages: torch.Tensor,      # (L, NB, BS, KV, hd)
    block_table: torch.Tensor,  # (b, MB) physical block per virtual block
    pos: torch.Tensor,          # (b,) current decode position per row
    poison: float,
) -> torch.Tensor:
    """repro-san's use-after-free oracle (the reference's
    ``paged_poison_counts``): per (layer, slot, virtual block) the count of
    committed positions whose gathered K or V row holds the poison fill
    (analysis/shadow.py ``POISON``, written over freed blocks).

    It gathers through ``block_table`` as :func:`paged_attention_ref` does,
    so a hit means a freed block is reachable by a slot at a position the
    mask does not exclude. Only positions ``t < pos[slot]`` count: lookahead
    blocks (allocated ahead of the write frontier, perhaps recycled and
    poisoned) and finished slots' sink-mapped rows stay clean. Runs on the
    pool's device; returns int32 (L, b, MB)."""
    ell, _, bs = k_pages.shape[:3]
    b, mb = block_table.shape
    dev = k_pages.device
    table = block_table.to(dev, torch.long)
    t = torch.arange(mb * bs, device=dev)
    committed = (t[None, :] < pos.to(dev, torch.long)[:, None]).reshape(b, mb, bs)
    out = torch.zeros((ell, b, mb), dtype=torch.int32, device=dev)
    for pages in (k_pages, v_pages):
        value = torch.tensor(poison, dtype=pages.dtype).to(dev)
        bad = (pages[:, table] == value).reshape(ell, b, mb, bs, -1).any(-1)
        out += (bad & committed[None]).sum(-1, dtype=torch.int32)
    return out


def flash_attention_ref(
    q: torch.Tensor,    # (b*H, s, hd), batch and heads flattened
    k: torch.Tensor,    # (b*KV, t, hd)
    v: torch.Tensor,    # (b*KV, t, hd)
    *,
    group: int,         # query heads per KV head: query row i reads KV row i // group
    scale: float,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    chunk: int | None = None,
    return_lse: bool = False,
):
    """Plain version of the flash-attention kernel (``csrc/flash_attn.cu``):
    the reference Pallas kernel's chunked online softmax
    (``flash_attention_pallas``), all in f32. Per K/V chunk: scores
    ``q . k * scale``, then ``softcap * tanh(s / softcap)``, then the masks
    (causal ``k_pos <= q_pos``, window ``q_pos - k_pos < window``, both
    counted from position 0) as ``NEG_INF``, then the running max, the
    rescaled denominator and accumulator; the output is
    ``acc / max(l, 1e-30)`` in q's dtype. ``chunk`` defaults to
    ``flags.attention_chunk``, cut to a divisor of t as the reference's
    ``_mha_blockwise`` cuts it. ``return_lse`` also returns each row's f32
    log-sum-exp of the (capped, masked) scores, m + log(l), (b*H, s): what
    the backward recomputes the softmax weights from."""
    bh, s, hd = q.shape
    t = k.shape[1]
    chunk = _chunk(t, chunk)
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(group, dim=0)
    vf = v.to(torch.float32).repeat_interleave(group, dim=0)
    m = torch.full((bh, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        sc = _flash_scores(qf, kf[:, c0:c0 + chunk], c0, scale=scale, causal=causal,
                           window=window, softcap=softcap)[0]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("hst,htd->hsd", p, vf[:, c0:c0 + chunk])
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def _chunk(t: int, chunk: int | None) -> int:
    """``flags.attention_chunk`` (or ``chunk``) cut to a divisor of t."""
    chunk = min(int(flags.get("attention_chunk") if chunk is None else chunk), t)
    while t % chunk:
        chunk //= 2
    return chunk


def _flash_scores(qf, kc, c0: int, *, scale, causal, window, softcap):
    """One K chunk's scores as the forward forms them: (capped, masked, the
    visible pairs, tanh of the cap's argument or None)."""
    s, chunk = qf.shape[1], kc.shape[1]
    sc = torch.einsum("hsd,htd->hst", qf, kc) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(sc / softcap)
        sc = softcap * th
    q_pos = torch.arange(s, device=qf.device)[:, None]
    k_pos = c0 + torch.arange(chunk, device=qf.device)[None, :]
    ok = torch.ones((s, chunk), dtype=torch.bool, device=qf.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= (q_pos - k_pos) < window
    return torch.where(ok, sc, NEG_INF), ok, th


def flash_attention_bwd_ref(
    q, k, v, out, lse, dout, *, group: int, scale: float, causal: bool = True,
    window: int | None = None, softcap: float | None = None, chunk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the flash-attention backward (``flash_attn_bwd`` in
    ``csrc/flash_attn.cu``): dQ, dK and dV of :func:`flash_attention_ref`
    given its output ``out``, its log-sum-exp ``lse`` (b*H, s) and the
    output's gradient ``dout``, written out step by step in f32 over
    ``flags.attention_chunk`` chunks of the keys (FlashAttention-2's
    scheme): D = rowsum(dO * O); per chunk the scores as the forward forms
    them, P = exp(s - lse), dV += P^T dO, dP = dO V^T, dS = P (dP - D) on
    the visible pairs (0 on masked ones, whose score is a constant), times
    1 - tanh^2 under a soft cap, times the scale; dQ += dS K, dK += dS^T Q.
    dK and dV sum over the group of query heads that reads each KV row.
    The gradients come back in q's, k's and v's dtypes."""
    bh, s, hd = q.shape
    bkv, t = k.shape[0], k.shape[1]
    chunk = _chunk(t, chunk)
    qf, of, dof = (x.to(torch.float32) for x in (q, out, dout))
    kf = k.to(torch.float32).repeat_interleave(group, dim=0)
    vf = v.to(torch.float32).repeat_interleave(group, dim=0)
    delta = (dof * of).sum(dim=-1)
    dq = torch.zeros((bh, s, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((bh, t, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((bh, t, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        kc, vc = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        sc, ok, th = _flash_scores(qf, kc, c0, scale=scale, causal=causal, window=window,
                                   softcap=softcap)
        p = torch.exp(sc - lse[..., None])
        dv[:, c0:c0 + chunk] = torch.einsum("hst,hsd->htd", p, dof)
        dp = torch.einsum("hsd,htd->hst", dof, vc)
        ds = torch.where(ok, p * (dp - delta[..., None]), 0.0)
        if th is not None:
            ds = ds * (1 - th * th)
        ds = ds * scale
        dq += torch.einsum("hst,htd->hsd", ds, kc)
        dk[:, c0:c0 + chunk] = torch.einsum("hst,hsd->htd", ds, qf)
    dk = dk.reshape(bkv, group, t, hd).sum(dim=1)
    dv = dv.reshape(bkv, group, t, hd).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_quant_ref(x: torch.Tensor, w: torch.Tensor, *, group_size: int,
                      eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused RMSNorm + int8 group quantization kernel
    (``csrc/rmsnorm_quant.cu``), the reference's oracle op for op: the
    port's ``rmsnorm`` on the f32 input, then ``quantize_groupwise``.
    x (m, n) any float dtype, w (n,) -> (int8 (m, n), f32 scales (m, n/GS))."""
    qt = quantize_groupwise(rmsnorm(x.to(torch.float32), w, eps), group_size)
    return qt.qvalues, qt.scales
