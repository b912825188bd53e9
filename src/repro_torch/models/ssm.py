"""Mamba2 (SSD) blocks for the zamba2 hybrid (counterpart of
``repro/models/ssm.py``).

Scalar-decay-per-head state-space recurrence:

    h_t = exp(-exp(A_log) * dt_t) * h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t @ C_t + D * x_t

The in/out projections (``win``, ``wout``) go through ``linear`` (GQMM under
quantized weights); the scan parameters (``a_log``, ``dt_bias``,
``d_skip``) and the depthwise conv stay float. The scan itself has no
Pallas kernel behind it in the reference and is plain PyTorch here: the
sequential form loops over positions on the f32 state h (b, H, hd, N), in
place where grad is off and out of place where autograd records (a train
step), the chunked form (``flags.chunked_ssd``) is Mamba2's matmul duality
per chunk. Decode's state is (conv tail, h), updated in the caller's cache
tensors in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import flags
from repro_torch.core.qlinear import linear, split_fused
from repro_torch.models.common import dense_init, rmsnorm


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, conv channels)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.state_dim


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...] = ()) -> dict:
    """The reference's Mamba2 leaves, ``lead`` stacked: the fused ``win``
    (z, x, B, C, dt), the depthwise ``conv_w`` (k, conv channels) N(0, 0.1²),
    f32 ``a_log`` / ``dt_bias`` zeros and ``d_skip`` ones, ``gate_norm``
    ones and ``wout``."""
    s = cfg.ssm
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    dt, dev = cfg.pdtype(), gen.device
    in_dim = 2 * d_inner + 2 * s.state_dim + nheads
    conv = torch.randn((*lead, s.conv_kernel, conv_ch), generator=gen, device=dev,
                       dtype=torch.float32) * 0.1
    return {
        "win": dense_init(gen, in_dim, cfg.d_model, dt, lead),
        "conv_w": conv.to(dt),
        "a_log": torch.zeros((*lead, nheads), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*lead, nheads), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((*lead, nheads), dtype=torch.float32, device=dev),
        "gate_norm": torch.ones((*lead, d_inner), dtype=dt, device=dev),
        "wout": dense_init(gen, cfg.d_model, d_inner, dt, lead),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no switch to the identity for large x
    (``F.softplus``'s threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _split_in(p, xin: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    return split_fused(linear(p["win"], xin),
                       (d_inner, d_inner, s.state_dim, s.state_dim, nheads))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None):
    """Depthwise causal conv. x (b, s, c); w (k, c) in x's dtype; tail
    (b, k-1, c). The reference's Python ``sum`` of the k taps, in tap order
    and in x's dtype (each add rounds at bf16). Returns (silu(out), the new
    tail (b, k-1, c))."""
    k, s = w.shape[0], x.shape[1]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if tail is None else tail)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out), xp[:, -(k - 1):, :]


def _ssd_scan(xs, Bv, Cv, dtv, a_neg, h: torch.Tensor, *, in_place: bool):
    """The sequential scan (the reference's ``_ssd_step`` at every position)
    on the f32 state ``h`` (b, H, hd, N). xs (b, s, H, hd), B and C (b, s,
    N), dt (b, s, H), all f32. The decay and dt·x of every position are
    taken before the loop (the same elementwise values); a step is the
    state's decay, its outer-product add and the contraction with C.
    ``in_place`` updates ``h`` itself (decode's cache views, serving);
    otherwise each step makes a new state with the same ops in the same
    order, which autograd can differentiate (the contraction saves every
    position's state). Returns (y (b, s, H, hd), the last state)."""
    decay = torch.exp(a_neg * dtv)                                  # (b, s, H)
    dx = dtv[..., None] * xs                                        # (b, s, H, hd)
    ys = []
    for t in range(xs.shape[1]):
        dec, dxt, bt = decay[:, t, :, None, None], dx[:, t, :, :, None], Bv[:, t, None, None, :]
        h = h.mul_(dec).addcmul_(dxt, bt) if in_place else torch.addcmul(h * dec, dxt, bt)
        ys.append(torch.matmul(h, Cv[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def _ssd_chunked(xs, Bv, Cv, dtv, a_neg, h0: torch.Tensor, chunk: int):
    """Mamba2's chunked SSD (matmul duality), the reference's: xs (b, s, H,
    hd); B, C (b, s, N); dt (b, s, H) (post-softplus, f32). Returns
    (y (b, s, H, hd), h_last). Per chunk of length Q, with P the inclusive
    cumsum of the log-decay:
      intra:  y[t] += sum_{s<=t} exp(P_t - P_s) * dt_s * (C_t.B_s) * x_s
      inter:  y[t] += exp(P_t) * C_t . h_in
      carry:  h_out = exp(P_Q) h_in + sum_s exp(P_Q - P_s) dt_s x_s (x) B_s"""
    b, s, H, hd = xs.shape
    nchunks = s // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device))
    h, ys = h0, []
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, Bq, Cq, dtq = xs[:, sl], Bv[:, sl], Cv[:, sl], dtv[:, sl]
        la = a_neg[None, None, :] * dtq                              # (b, Q, H), <= 0
        P = torch.cumsum(la, dim=1)
        G = torch.einsum("btn,bsn->bts", Cq, Bq)                     # (b, Q, Q)
        # the exponent masked before exp: above the diagonal P_t - P_s > 0
        # overflows f32 past ~88 (a chunk of 128 at dt ~0.7), and the
        # reference's exp-then-where gives NaN gradients there (inf * 0);
        # the kept entries are the same values
        diff = torch.where(tri[None, :, :, None], P[:, :, None, :] - P[:, None, :, :], -torch.inf)
        M = G[..., None] * (torch.exp(diff) * dtq[:, None, :, :])
        y = torch.einsum("btsh,bshd->bthd", M, xq)                   # intra
        y = y + torch.exp(P)[..., None] * torch.einsum("bhdn,btn->bthd", h, Cq)
        wfull = torch.exp(P[:, -1:, :] - P) * dtq                    # (b, Q, H)
        h = torch.exp(P[:, -1, :])[:, :, None, None] * h + torch.einsum(
            "bsh,bshd,bsn->bhdn", wfull, xq, Bq)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _gated_out(p, y, xs, z, x_dtype, cfg: ModelConfig) -> torch.Tensor:
    """D·x added in f32, the cast to x's dtype, then rmsnorm(y * silu(z))
    and ``wout``."""
    y = y + p["d_skip"][:, None] * xs
    y = y.reshape(*y.shape[:-2], -1).to(x_dtype)
    return linear(p["wout"], rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps))


def mamba2_forward(p, x: torch.Tensor, cfg: ModelConfig, state=None):
    """x (b, s, d) -> (y, (conv_tail, h_last)). ``state`` (conv_tail, h)
    continues a sequence (its h is not written). The chunked scan runs
    where the reference takes it: ``flags.chunked_ssd``, s a multiple of
    ``flags.ssd_chunk`` and longer than one chunk."""
    sc = cfg.ssm
    b, s, _ = x.shape
    d_inner, nheads, _ = ssm_dims(cfg)
    z, xc, Bv, Cv, dtv = _split_in(p, x, cfg)
    conv_in = torch.cat([xc, Bv, Cv], dim=-1)
    conv_out, conv_tail = _causal_conv(conv_in, p["conv_w"].to(x.dtype),
                                       None if state is None else state[0])
    xc, Bv, Cv = split_fused(conv_out, (d_inner, sc.state_dim, sc.state_dim))
    dtv = softplus(dtv.to(torch.float32) + p["dt_bias"])                  # (b, s, H)
    xs = xc.reshape(b, s, nheads, sc.head_dim).to(torch.float32)
    a_neg = -torch.exp(p["a_log"])
    h = (torch.zeros((b, nheads, sc.head_dim, sc.state_dim), dtype=torch.float32,
                     device=x.device) if state is None else state[1].clone())
    Bf, Cf = Bv.to(torch.float32), Cv.to(torch.float32)
    chunk = int(flags.get("ssd_chunk"))
    if flags.get("chunked_ssd") and s % chunk == 0 and s > chunk:
        y, h = _ssd_chunked(xs, Bf, Cf, dtv, a_neg, h, chunk)
    else:
        y, h = _ssd_scan(xs, Bf, Cf, dtv, a_neg, h, in_place=not torch.is_grad_enabled())
    return _gated_out(p, y, xs, z, x.dtype, cfg), (conv_tail, h)


def mamba2_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    """x (b, d) one token; state (conv_tail (b, k-1, c), h (b, H, hd, N)),
    both updated IN PLACE (views of the caller's cache). Returns (y,
    state)."""
    sc = cfg.ssm
    b = x.shape[0]
    d_inner, nheads, _ = ssm_dims(cfg)
    conv_tail, h = state
    z, xc, Bv, Cv, dtv = _split_in(p, x[:, None, :], cfg)
    conv_in = torch.cat([xc, Bv, Cv], dim=-1)
    conv_out, tail = _causal_conv(conv_in, p["conv_w"].to(x.dtype), conv_tail)
    conv_tail.copy_(tail)
    xc, Bv, Cv = split_fused(conv_out, (d_inner, sc.state_dim, sc.state_dim))
    dt1 = softplus(dtv.to(torch.float32) + p["dt_bias"])                  # (b, 1, H)
    xs = xc.reshape(b, 1, nheads, sc.head_dim).to(torch.float32)
    y, _ = _ssd_scan(xs, Bv.to(torch.float32), Cv.to(torch.float32), dt1,
                     -torch.exp(p["a_log"]), h, in_place=True)
    return _gated_out(p, y[:, 0], xs[:, 0], z[:, 0], x.dtype, cfg), (conv_tail, h)
