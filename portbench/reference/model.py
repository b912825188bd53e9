"""Plain reference of the benchmark's decoder models, in float32.

A full forward pass over whole sequences, with no cache, no batching and no
kernel: embedding, RMSNorm, rotate-half RoPE, grouped-query attention or
multi-head latent attention (materialised K/V from the latent), SwiGLU or the
top-k mixture of experts with shared experts, the final norm and the
classifier. The configuration states W8A8: every projection weight is
quantized group-wise to int8 here, from the float weights that
``portbench/weights.py`` draws from the seed (one layer at a time), and every
projection input is quantized group-wise to int8 at run time; the product is
taken in float32 on the dequantized values. Nothing here imports the program
or anything it made.

Departures from the published models, shared with the program and stated in
each configuration file: no RoPE scaling; the router's top-k weights are
renormalised to sum to 1; deepseek-v2-lite's layer 0 is a MoE layer.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W

MIN_GROUP = 16
QMAX = 127


def set_exact_float32() -> None:
    """float32 products in float32: no TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def group_size(n: int, preferred: int) -> int:
    """The largest power of two <= ``preferred`` (and >= 16) dividing n."""
    gs = preferred
    while gs >= MIN_GROUP:
        if n % gs == 0:
            return gs
        gs //= 2
    raise ValueError(f"no group size in [{MIN_GROUP}, {preferred}] divides {n}")


def fake_quant(x: torch.Tensor, gs: int, qmax: int = QMAX) -> torch.Tensor:
    """Group-wise symmetric quantization along the last axis, dequantized:
    S = 2 max|x| / (2 qmax + 1), q = round-half-even(x / S) clipped to
    [-qmax, qmax], returned as q * S in float32."""
    n = x.shape[-1]
    g = x.to(torch.float32).reshape(*x.shape[:-1], n // gs, gs)
    s = g.abs().amax(dim=-1, keepdim=True) * (2.0 / (2 * qmax + 1))
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(g / safe), -qmax, qmax)
    return (q * s).reshape(x.shape)


class Weights:
    """Float weights of one configuration drawn again from the seed, slice by
    slice, and quantized here."""

    def __init__(self, shape: dict, quant: dict, seed: int, device):
        self.shape, self.seed, self.device = shape, seed, device
        if quant["format"] != "int8":
            raise ValueError(f"the reference computes W8A8, not {quant['format']}")
        self.preferred = quant["group_size"]

    def float(self, path: str, layer: int | None) -> torch.Tensor:
        return W.draw(self.shape, self.seed, path, layer, self.device, dtype=torch.float32)

    def proj(self, path: str, layer: int | None) -> tuple[torch.Tensor, int]:
        """(dequantized weight (..., out, in), its group size)."""
        w = self.float(path, layer)
        gs = group_size(w.shape[-1], self.preferred)
        return fake_quant(w, gs), gs


def linear(x: torch.Tensor, w: tuple[torch.Tensor, int]) -> torch.Tensor:
    """W8A8: x quantized group-wise at the weight's group size, times W^T."""
    wd, gs = w
    return fake_quant(x, gs) @ wd.T


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over positions 0..s-1; x (s, heads, dim)."""
    s, dim = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float, rows: int = 1024) -> torch.Tensor:
    """softmax(q k^T scale + causal mask) v, per head, a block of query rows
    at a time; q (s, H, dq), k (s, H, dq), v (s, H, dv) -> (s, H * dv)."""
    s, h = q.shape[:2]
    out = torch.empty((s, h, v.shape[-1]), dtype=torch.float32, device=q.device)
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)                 # (H, dq, s) / (H, s, dv)
    for a in range(0, s, rows):
        b = min(s, a + rows)
        sc = torch.matmul(q[a:b].permute(1, 0, 2), kt[:, :, :b]) * scale   # (H, r, b)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, -math.inf)
        out[a:b] = torch.matmul(torch.softmax(sc, dim=-1), vt[:, :b]).permute(1, 0, 2)
    return out.reshape(s, -1)


def swiglu(x, w13, w2) -> torch.Tensor:
    f = w2[0].shape[-1]
    gu = linear(x, w13)
    return linear(torch.nn.functional.silu(gu[..., :f]) * gu[..., f:], w2)


def gqa(x, lw: dict, shape: dict) -> torch.Tensor:
    s = x.shape[0]
    h, kvh, hd = shape["num_heads"], shape["num_kv_heads"], W.head_dim(shape)
    qkv = linear(x, lw["attn/wqkv"])
    q = qkv[:, : h * hd].reshape(s, h, hd)
    k = qkv[:, h * hd: (h + kvh) * hd].reshape(s, kvh, hd)
    v = qkv[:, (h + kvh) * hd:].reshape(s, kvh, hd)
    theta = shape["rope_theta"]
    q, k = rope(q, theta), rope(k, theta)
    g = h // kvh
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    return linear(causal_attention(q, k, v, hd ** -0.5), lw["attn/wo"])


def mla(x, lw: dict, shape: dict) -> torch.Tensor:
    m, h, s = shape["mla"], shape["num_heads"], x.shape[0]
    nope, rdim, vdim, kvr = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"], m["kv_lora_rank"]
    theta, eps = shape["rope_theta"], shape["norm_eps"]
    q = linear(x, lw["attn/wq"]).reshape(s, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], theta)
    c = linear(x, lw["attn/wdkv"])
    c_kv = rmsnorm(c[:, :kvr], lw["attn/kv_norm"], eps)
    k_rope = rope(c[:, None, kvr:], theta)                           # (s, 1, rope)
    kv = linear(c_kv, lw["attn/wukv"]).reshape(s, h, nope + vdim)
    k = torch.cat([kv[..., :nope], k_rope.expand(s, h, rdim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    return linear(causal_attention(qf, k, kv[..., nope:], (nope + rdim) ** -0.5),
                  lw["attn/wo"])


def moe(x, lw: dict, shape: dict) -> torch.Tensor:
    m = shape["moe"]
    probs = torch.softmax(x @ lw["mlp/router_w"].T, dim=-1)
    top_p, top_i = torch.topk(probs, m["top_k"], dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    (w13, gs13), (w2, gs2) = lw["mlp/experts/w13"], lw["mlp/experts/w2"]
    y = torch.zeros_like(x)
    for e in torch.unique(top_i).tolist():
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        out = swiglu(x[rows], (w13[e], gs13), (w2[e], gs2))
        y.index_add_(0, rows, out * top_p[rows, slot][:, None])
    if m.get("num_shared"):
        y = y + swiglu(x, lw["mlp/shared/w13"], lw["mlp/shared/w2"])
    return y


def layer_weights(wts: Weights, shape: dict, i: int) -> dict:
    out = {}
    for path, (_, stacked, scale, _) in W.leaf_specs(shape).items():
        if not stacked:
            continue
        name = path[len("layers/"):]
        if scale == 0.0 or name.endswith("router_w"):
            out[name] = wts.float(path, i)                  # norms, the float router
        else:
            out[name] = wts.proj(path, i)
    return out


@torch.no_grad()
def logits_at(shape: dict, quant: dict, seed: int, device, seqs: list, positions: list
              ) -> list[torch.Tensor]:
    """For each token sequence ``seqs[j]`` (1-D long), the float32 logits
    (len(positions[j]), vocab_padded) at the given positions, layer by layer
    over all sequences."""
    set_exact_float32()
    wts = Weights(shape, quant, seed, device)
    eps = shape["norm_eps"]
    emb, _ = wts.proj("embed", None)
    hs = [emb[torch.as_tensor(t, device=device)] for t in seqs]
    del emb
    attn = mla if shape.get("mla") else gqa
    ffn = moe if shape.get("moe") else (lambda x, lw, _s: swiglu(x, lw["mlp/w13"], lw["mlp/w2"]))
    for i in range(shape["num_layers"]):
        lw = layer_weights(wts, shape, i)
        for j, h in enumerate(hs):
            h = h + attn(rmsnorm(h, lw["att_norm"], eps), lw, shape)
            hs[j] = h + ffn(rmsnorm(h, lw["ffn_norm"], eps), lw, shape)
        del lw
    final = wts.float("final_norm", None)
    cls = wts.proj("classifier", None)
    return [linear(rmsnorm(h[torch.as_tensor(p, device=device)], final, eps), cls)
            for h, p in zip(hs, positions)]
