"""Least time one H100 could take for the function of each TPU kernel of the
reference package, computed from a ported config's shapes.

    python -m repro_torch.kernels.bounds [--arch ID ... | --arch all]

(TinyLlama-1.1B by default; ``all`` prints every ported config's table.)

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the HBM rate, and the
operations it must do over the card's peak rate for their type (NVIDIA's
data sheet, H100 SXM, dense, at 700 W). Nothing here runs a kernel; the
paged-attention bound depends on the positions of a run and is computed by
``chip_smoke.py`` from its own inputs.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import largest_pow2_group
from repro_torch.models.rwkv import DECAY_LORA_RANK, MIXES

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "f32": 67e12}
# weight formats of the reference's GQMV/GQMM kernels: bits per stored value
# and the operations' type (int formats take the int8 tensor rate; e4m3
# weights times int8 activations take the f16 / bf16 rate, the one type of
# the tensor cores that holds both exactly)
WEIGHT_BITS = {"int8": 8, "int4": 4, "int3": 3, "fp8": 8}


@dataclasses.dataclass(frozen=True)
class Bound:
    nbytes: int
    ops: int
    rate: str

    @property
    def seconds(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / PEAK_OPS_PER_S[self.rate])

    @property
    def bound_by(self) -> str:
        tb = self.nbytes / HBM_BYTES_PER_S
        return "bytes" if tb >= self.ops / PEAK_OPS_PER_S[self.rate] else "operations"


def _gqa_swiglu(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return [("wqkv", (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, d, 1),
            ("wo", d, cfg.num_heads * hd, 1),
            ("w13", 2 * cfg.d_ff, d, 1), ("w2", d, cfg.d_ff, 1)]


def layer_projections(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """(name, m, n, count) of one layer's quantized weight matrices: GQA's
    wqkv and wo, or MLA's query projection(s), wdkv, wukv and wo; the dense
    SwiGLU's w13 and w2, or every expert's (count E) and the shared
    expert's. Every one is read each step (MLA's decode dequantizes wukv
    where prefill runs it as a GQMM). rwkv6: the time mix's wr, wk, wv, wg,
    wout and the channel mix's wffr, wff1, wff2. zamba2: a Mamba2 layer's
    win and wout, then the shared block's four ("shared ..."), which a
    pass reads once per application (``pass_projections``). The
    encoder-decoder: an encoder layer's wqkv, wo, w13, w2 ("enc ...") and a
    decoder layer's, with the cross attention's wq, wkv and wo ("dec
    ...")."""
    d, h = cfg.d_model, cfg.num_heads
    if cfg.model_type == "encdec":
        gqa = _gqa_swiglu(cfg)
        cross = [("cross wq", cfg.q_dim, d, 1), ("cross wkv", 2 * cfg.kv_dim, d, 1),
                 ("cross wo", d, cfg.q_dim, 1)]
        return ([(f"enc {name}", m, n, c) for name, m, n, c in gqa]
                + [(f"dec {name}", m, n, c) for name, m, n, c in gqa[:2] + cross + gqa[2:]])
    if cfg.model_type == "rwkv6":
        return ([(name, d, d, 1) for name in ("wr", "wk", "wv", "wg", "wout", "wffr")]
                + [("wff1", cfg.d_ff, d, 1), ("wff2", d, cfg.d_ff, 1)])
    if cfg.model_type == "zamba2":
        s = cfg.ssm
        d_inner = s.expand * d
        win = 2 * d_inner + 2 * s.state_dim + d_inner // s.head_dim
        return ([("win", win, d, 1), ("wout", d, d_inner, 1)]
                + [(f"shared {name}", m, n, c) for name, m, n, c in _gqa_swiglu(cfg)])
    if cfg.mla:
        m = cfg.mla
        qk = h * (m.qk_nope_dim + m.qk_rope_dim)
        out = ([("wdq", m.q_lora_rank, d, 1), ("wuq", qk, m.q_lora_rank, 1)]
               if m.q_lora_rank else [("wq", qk, d, 1)])
        out += [("wdkv", m.kv_lora_rank + m.qk_rope_dim, d, 1),
                ("wukv", h * (m.qk_nope_dim + m.v_head_dim), m.kv_lora_rank, 1),
                ("wo", d, h * m.v_head_dim, 1)]
    else:
        hd = cfg.resolved_head_dim
        out = [("wqkv", (h + 2 * cfg.num_kv_heads) * hd, d, 1), ("wo", d, h * hd, 1)]
    if cfg.moe:
        e, f = cfg.moe.num_experts, cfg.moe.d_expert
        out += [("expert w13", 2 * f, d, e), ("expert w2", d, f, e)]
        if cfg.moe.num_shared:
            fs = f * cfg.moe.num_shared
            out += [("shared w13", 2 * fs, d, 1), ("shared w2", d, fs, 1)]
    else:
        out += [("w13", 2 * cfg.d_ff, d, 1), ("w2", d, cfg.d_ff, 1)]
    return out


def pass_projections(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """(name, m, n, count) of the quantized projections of one forward pass
    (the classifier apart): each layer's, zamba2's shared block once per
    application (num_layers // shared_attn_every: its 205.5 M weights do
    not stay in the L2 from one application to the next), and the
    encoder-decoder's encoder layers encoder_layers times."""
    out = []
    for name, m, n, c in layer_projections(cfg):
        if cfg.model_type == "zamba2" and name.startswith("shared "):
            layers = cfg.num_layers // cfg.shared_attn_every
        elif name.startswith("enc "):
            layers = cfg.encoder_layers
        else:
            layers = cfg.num_layers
        out.append((name, m, n, c * layers))
    return out


def projections(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(m, n, count) of the quantized projections of one forward pass."""
    return ([(m, n, c) for _, m, n, c in pass_projections(cfg)]
            + [(cfg.vocab_size, cfg.d_model, 1)])


def group_size(cfg: ModelConfig, n: int) -> int:
    """The weight policy's group size for a contraction of n
    (``core/policy.leaf_group_size``)."""
    return largest_pow2_group(n, cfg.group_size, min_gs=16)


def projection(fmt: str, m: int, n: int, b: int, gs: int) -> Bound:
    """One W8A8-style projection (m, n) at batch b: weights at ``fmt``'s
    width and their f32 group scales, int8 activations and their scales in,
    f32 outputs out; 2 operations per multiply-add."""
    nbytes = m * n * WEIGHT_BITS[fmt] // 8 + 4 * m * n // gs + b * n + 4 * b * n // gs + 4 * b * m
    return Bound(nbytes, 2 * b * m * n, "bf16" if fmt == "fp8" else "int8")


def decode_projections(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(m, n, count) of the projections a decode step reads: a forward
    pass's (:func:`projections`), but for the encoder-decoder the decoder's
    and the classifier only (the encoder and the cross ``wkv`` run once, at
    prefill)."""
    if cfg.model_type != "encdec":
        return projections(cfg)
    return ([(m, n, c) for name, m, n, c in pass_projections(cfg)
             if name.startswith("dec ") and name != "dec cross wkv"]
            + [(cfg.vocab_size, cfg.d_model, 1)])


def _projections_bound(cfg: ModelConfig, fmt: str, b: int, projs) -> Bound:
    """The sum of a :func:`projection` at its group size for each (m, n,
    count) of ``projs`` at batch b."""
    nbytes = ops = 0
    for m, n, count in projs:
        one = projection(fmt, m, n, b, group_size(cfg, n))
        nbytes += count * one.nbytes
        ops += count * one.ops
    return Bound(nbytes, ops, "bf16" if fmt == "fp8" else "int8")


def projection_pass(cfg: ModelConfig, fmt: str, b: int) -> Bound:
    """Every projection of one forward pass at batch b (TinyLlama's 4 L + 1
    = 89), each a :func:`projection` at its group size."""
    return _projections_bound(cfg, fmt, b, projections(cfg))


DTYPE_BYTES = {"bf16": 2, "f32": 4}
# the encoder-decoder's table rows: the encoder's non-causal flash
# attention at (b, s_enc), and the decode step at (b, s_enc)
ENCDEC_FLASH = ((4, 512),)
ENCDEC_DECODE = ((1, 512), (4, 512))


def recurrent_state_bytes(cfg: ModelConfig, b: int) -> int:
    """Bytes of a recurrent family's O(1) decode state, read and written
    once each decode step at batch b (0 for the others): rwkv6's f32 wkv
    (L, b, h, hd, hd) and its two token-shift rows (L, b, d); zamba2's f32
    SSM state h (L, b, H, hd, N) and conv tails (L, b, k-1, channels). The
    compute dtype's rows at bf16 width (the shared KV cache is attention's
    and grows with the cache length: not counted)."""
    e = DTYPE_BYTES["bf16"] if cfg.compute_dtype == "bfloat16" else DTYPE_BYTES["f32"]
    L = cfg.num_layers
    if cfg.model_type == "rwkv6":
        hd = cfg.resolved_head_dim
        one = 4 * b * cfg.d_model * hd + e * 2 * b * cfg.d_model
    elif cfg.model_type == "zamba2":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        one = 4 * b * d_inner * s.state_dim + e * b * (s.conv_kernel - 1) * (
            d_inner + 2 * s.state_dim)
    else:
        return 0
    return 2 * L * one


def cross_kv_bytes(cfg: ModelConfig, b: int, s_enc: int) -> int:
    """Bytes of the encoder-decoder's cross K/V that a decode step reads at
    batch b over s_enc encoder positions: L x b x s_enc x 2 x kv_dim in the
    compute dtype (0 for the others)."""
    if cfg.model_type != "encdec":
        return 0
    e = DTYPE_BYTES["bf16"] if cfg.compute_dtype == "bfloat16" else DTYPE_BYTES["f32"]
    return cfg.num_layers * b * s_enc * 2 * cfg.kv_dim * e


def decode_step(cfg: ModelConfig, fmt: str, b: int, s_enc: int = 0) -> Bound:
    """A decode step's bytes and operations at batch b: the projections it
    reads (:func:`decode_projections`), the recurrent state read and written
    (:func:`recurrent_state_bytes`), and the encoder-decoder's cross K/V
    over ``s_enc`` encoder positions (:func:`cross_kv_bytes`)."""
    p = _projections_bound(cfg, fmt, b, decode_projections(cfg))
    return Bound(p.nbytes + recurrent_state_bytes(cfg, b) + cross_kv_bytes(cfg, b, s_enc),
                 p.ops, p.rate)


def rmsnorm_quant(cfg: ModelConfig, b: int, n: int | None = None, dtype: str = "bf16") -> Bound:
    """One fused RMSNorm + int8 activation quantization of (b, n) rows
    (n = d_model by default) stored as ``dtype``: x and the norm weight (of
    the same type) in, int8 rows and f32 group scales out. The reference
    kernel reads any float type and computes in f32, so each input type is
    its own row of the table; about 8 f32 operations per element (square,
    sum, scale, weight, absmax, divide, round, clip)."""
    n = cfg.d_model if n is None else n
    e = DTYPE_BYTES[dtype]
    return Bound(e * b * n + e * n + b * n + 4 * b * n // cfg.group_size, 8 * b * n, "f32")


def flash_prefill(cfg: ModelConfig, b: int, s: int, dtype: str = "bf16",
                  causal: bool = True) -> Bound:
    """One layer's prefill attention over (b, s) tokens stored as
    ``dtype``: q and out (b, H, s, hd), k and v (b, KV, s, hd); q . k and
    p . v over the s (s + 1) / 2 causal pairs of each head (s x s when not
    ``causal``: the encoder's), at the tensor cores' bf16 rate (f32 inputs
    at the f32 rate outside them)."""
    hd = cfg.resolved_head_dim
    q = b * cfg.num_heads * s * hd
    kv = b * cfg.num_kv_heads * s * hd
    e = DTYPE_BYTES[dtype]
    pairs = s * (s + 1) // 2 if causal else s * s
    return Bound(e * (2 * q + 2 * kv), 4 * b * cfg.num_heads * hd * pairs, dtype)


def flash_backward_bound(bh: int, bkv: int, s: int, t: int, hd: int, pairs: int,
                         dtype: str = "bf16") -> Bound:
    """The backward of flash attention over q (bh, s, hd) and k, v (bkv, t,
    hd) with ``pairs`` visible (query, key) pairs: q, k, v, out, dout and the
    f32 log-sum-exp read once, dq, dk, dv written once; five products (S,
    dP, dV, dQ, dK) of 2 * hd operations a visible pair, at the bf16
    tensor-core rate (f32 inputs at the f32 rate)."""
    e = DTYPE_BYTES[dtype]
    return Bound(e * (4 * bh * s * hd + 4 * bkv * t * hd) + 4 * bh * s, 10 * hd * pairs, dtype)


def flash_backward(cfg: ModelConfig, b: int, s: int, dtype: str = "bf16",
                   causal: bool = True) -> Bound:
    """One layer's attention backward over (b, s) tokens (B4's backward: the
    reference has no Pallas kernel for it; XLA differentiates
    ``_mha_blockwise``), causal or over every pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return flash_backward_bound(b * cfg.num_heads, b * cfg.num_kv_heads, s, s,
                                cfg.resolved_head_dim, b * cfg.num_heads * pairs, dtype)


def scan_state(cfg: ModelConfig) -> int:
    """f32 state elements one recurrent layer updates and contracts at each
    position of a batch row: rwkv6's wkv (h, hd, hd), d x hd; a zamba2
    Mamba2 layer's h (H, hd, N), d_inner x N; 0 for the others."""
    if cfg.model_type == "rwkv6":
        return cfg.d_model * cfg.resolved_head_dim
    if cfg.model_type == "zamba2":
        return cfg.ssm.expand * cfg.d_model * cfg.ssm.state_dim
    return 0


def train_params(cfg: ModelConfig) -> int:
    """Parameters a train step updates. ``decoder_lm``: the projections of
    a pass, the embedding (and an untied classifier), two norms a layer and
    the final norm (a layer's other small leaves not counted). rwkv6 and
    zamba2: every leaf (rwkv6's mixes, decay LoRA and ``bonus_u``; zamba2's
    conv, scan parameters and gate norm, its shared block once)."""
    d, L = cfg.d_model, cfg.num_layers
    head = cfg.vocab_padded * d * (1 if cfg.tie_embeddings else 2)
    if cfg.model_type == "rwkv6":
        small = (len(MIXES) + 4) * d + 2 * DECAY_LORA_RANK * d + d
        return sum(m * n * c for _, m, n, c in pass_projections(cfg)) + L * small + head + d
    if cfg.model_type == "zamba2":
        s = cfg.ssm
        d_inner = s.expand * d
        mamba = sum(m * n for name, m, n, _ in layer_projections(cfg)
                    if not name.startswith("shared "))
        small = (d + s.conv_kernel * (d_inner + 2 * s.state_dim)
                 + 3 * d_inner // s.head_dim + d_inner)
        shared = sum(m * n for name, m, n, _ in layer_projections(cfg)
                     if name.startswith("shared ")) + 2 * d
        return L * (mamba + small) + shared + head + d
    layer = sum(m * n * c for _, m, n, c in pass_projections(cfg))
    return layer + head + (2 * L + 1) * d


def train_step(cfg: ModelConfig, b: int, s: int, dtype: str = "bf16") -> Bound:
    """One AdamW train step over (b, s) tokens with ``remat``: each
    recomputed layer's projections (2 operations a weight a token; a MoE's
    every expert, as its dense dispatch runs them) in the forward, again in
    the recomputed forward and twice in the backward (dX and dW); zamba2's
    shared block, which is not recomputed, three times an application;
    the classifier three times. Attention's causal products:
    ``flash_prefill``'s twice and ``flash_backward``'s once a layer, or at
    zamba2's hd 112 once each an application of the shared block (none for
    rwkv6). The recurrent scans: a multiply-add per state element
    (:func:`scan_state`) a position for the update and one for the
    contraction, in the forward and the recomputed forward, and twice that
    in the backward (a multiply-add's gradient is two); all at the ``dtype``
    rate. Bytes: what the update must move, each parameter
    (:func:`train_params`) and its gradient read and written in ``dtype``
    and its f32 m and v read and written (activations, which depend on the
    kernels' fusion, not counted)."""
    e = DTYPE_BYTES[dtype]
    projs = pass_projections(cfg)
    shared = sum(m * n * c for name, m, n, c in projs
                 if cfg.model_type == "zamba2" and name.startswith("shared "))
    layer = sum(m * n * c for _, m, n, c in projs) - shared
    head = cfg.vocab_padded * cfg.d_model
    tok = b * s
    fwd, bwd = flash_prefill(cfg, b, s, dtype).ops, flash_backward(cfg, b, s, dtype).ops
    if cfg.model_type == "zamba2":
        attn = cfg.num_layers // cfg.shared_attn_every * (fwd + bwd)
    elif cfg.num_kv_heads:
        attn = cfg.num_layers * (2 * fwd + bwd)
    else:
        attn = 0
    scan = 4 * 4 * tok * cfg.num_layers * scan_state(cfg)
    ops = 2 * tok * (4 * layer + 3 * shared + 3 * head) + attn + scan
    return Bound((4 * e + 16) * train_params(cfg), ops, dtype)


def table(cfg: ModelConfig) -> list[tuple[str, str, Bound]]:
    rows = [("B1 gqmv_pallas (int8)", "one pass, b=1", projection_pass(cfg, "int8", 1)),
            ("B3 gqmm_pallas (int8)", "one pass, b=4", projection_pass(cfg, "int8", 4)),
            ("B3 gqmm_pallas (int8)", "one pass, b=256", projection_pass(cfg, "int8", 256))]
    for tag, fmt in (("B5", "int4"), ("B6", "int3"), ("B7", "fp8")):
        rows += [(f"{tag} gqmv_{fmt}_pallas", "one pass, b=1", projection_pass(cfg, fmt, 1)),
                 (f"{tag} gqmm_{fmt}_pallas", "one pass, b=4", projection_pass(cfg, fmt, 4)),
                 (f"{tag} gqmm_{fmt}_pallas", "one pass, b=256", projection_pass(cfg, fmt, 256))]
    for dt in ("bf16", "f32"):
        rows += [("B2 rmsnorm_quant_pallas", f"one call, {dt} ({b}, {n})",
                  rmsnorm_quant(cfg, b, n, dt))
                 for b, n in ((4, cfg.d_model), (256, cfg.d_model), (256, cfg.d_ff))]
    for dt in ("bf16", "f32"):
        # rwkv6 has no attention
        rows += [("B4 flash_attention_pallas", f"one layer, {dt} {b} x {s} tokens",
                  flash_prefill(cfg, b, s, dt)) for b, s in ((4, 64), (1, 2048))
                 if cfg.num_kv_heads]
    if cfg.model_type in ("rwkv6", "zamba2"):
        rows += [("decode step (int8)", f"projections + recurrent state, b={b}",
                  decode_step(cfg, "int8", b)) for b in (1, 4)]
    if cfg.model_type == "encdec":
        rows += [("B4 flash_attention_pallas", f"one encoder layer, bf16 {b} x {s}, non-causal",
                  flash_prefill(cfg, b, s, "bf16", causal=False)) for b, s in ENCDEC_FLASH]
        rows += [("decode step (int8)", f"decoder + classifier + cross K/V, b={b}, "
                  f"s_enc={s_enc}", decode_step(cfg, "int8", b, s_enc))
                 for b, s_enc in ENCDEC_DECODE]
    return rows


def main(argv=None) -> None:
    import argparse

    from repro_torch.models.registry import PORTED_ARCHS, load_config

    ap = argparse.ArgumentParser(description="shape-derived bounds of every TPU kernel's "
                                             "function, per ported config")
    ap.add_argument("--arch", nargs="+", default=["tinyllama-1.1b"],
                    help=f"config ids, or 'all' ({', '.join(PORTED_ARCHS)})")
    args = ap.parse_args(argv)
    archs = PORTED_ARCHS if args.arch == ["all"] else args.arch
    for arch in archs:
        print(f"{arch}:")
        print(f"{'kernel':28s} {'work':32s} {'bytes':>13s} {'operations':>15s} "
              f"{'bound us':>10s}  by")
        for name, work, bnd in table(load_config(arch)):
            print(f"{name:28s} {work:32s} {bnd.nbytes:13d} {bnd.ops:15d} "
                  f"{1e6 * bnd.seconds:10.3f}  {bnd.bound_by}")


if __name__ == "__main__":
    main()
