"""The least time one H100 could take for the work a run's inputs need.

Arithmetic frozen from the port's ``kernels/bounds.py`` (``projection``,
``layer_projections``, the data-sheet peaks), extended to whole prefills and
decode steps, multi-head latent attention and the mixture of experts. It
counts the work the inputs need and not what the program happens to do:

- each input byte read once and each output byte written once: the weights
  and their f32 group scales, int8 activations and their scales in, f32
  projection outputs out, the KV (or latent) rows that are live;
- a MoE layer's routed experts at ``top_k`` a token (operations) and at the
  fewest distinct experts the routing allows, ``top_k`` a layer (bytes),
  since the run records no router choice; the shared experts always;
- prompts at their true lengths (no bucket padding), causal pairs only;
- no step the output does not need (``generate``'s discarded last step).

Operations and bytes combine as in a roofline: a unit of work takes at least
max(bytes / HBM rate, int8 operations / int8 peak + bf16 operations / bf16
peak). Summing bytes and operations over many steps before taking the max
gives a lower bound of the per-step sum, so a share of it never passes 100%
where the per-step bound would not. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

# NVIDIA's data sheet, H100 SXM, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
WEIGHT_BITS = {"int8": 8, "int4": 4}
ACT_BYTES = 2            # bf16 activations and KV rows


@dataclasses.dataclass
class Work:
    nbytes: float = 0.0
    int8_ops: float = 0.0
    bf16_ops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.nbytes + other.nbytes, self.int8_ops + other.int8_ops,
                    self.bf16_ops + other.bf16_ops)

    def scaled(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.int8_ops * k, self.bf16_ops * k)

    @property
    def seconds(self) -> float:
        ops = (self.int8_ops / PEAK_OPS_PER_S["int8"]
               + self.bf16_ops / PEAK_OPS_PER_S["bf16"])
        return max(self.nbytes / HBM_BYTES_PER_S, ops)


def group_size(n: int, preferred: int) -> int:
    """The largest power of two <= ``preferred`` (and >= 16) dividing n."""
    gs = preferred
    while gs >= 16 and n % gs:
        gs //= 2
    return gs


def projection(m: int, n: int, b: int, gs: int, fmt: str = "int8") -> Work:
    """One W8A8 projection (m, n) at b rows (``bounds.projection``): weights
    and their f32 group scales, int8 activations and their scales in, f32
    outputs out; 2 operations a multiply-add."""
    nbytes = (m * n * WEIGHT_BITS[fmt] // 8 + 4 * m * n // gs + b * n + 4 * b * n // gs
              + 4 * b * m)
    return Work(nbytes, 2 * b * m * n, 0)


def layer_projections(shape: dict) -> list[tuple[str, int, int, str]]:
    """(name, m, n, kind) of one layer's quantized weight matrices
    (``bounds.layer_projections`` for the GQA and MLA decoders); ``kind`` is
    "routed" for one routed expert's matrices, "dense" for the rest."""
    d, h = shape["d_model"], shape["num_heads"]
    mla = shape.get("mla")
    if mla:
        qk = h * (mla["qk_nope_dim"] + mla["qk_rope_dim"])
        out = [("wq", qk, d, "dense"),
               ("wdkv", mla["kv_lora_rank"] + mla["qk_rope_dim"], d, "dense"),
               ("wukv", h * (mla["qk_nope_dim"] + mla["v_head_dim"]), mla["kv_lora_rank"],
                "dense"),
               ("wo", d, h * mla["v_head_dim"], "dense")]
    else:
        hd = shape.get("head_dim") or d // h
        out = [("wqkv", (h + 2 * shape["num_kv_heads"]) * hd, d, "dense"),
               ("wo", d, h * hd, "dense")]
    moe = shape.get("moe")
    if moe:
        f = moe["d_expert"]
        out += [("expert w13", 2 * f, d, "routed"), ("expert w2", d, f, "routed")]
        if moe.get("num_shared"):
            fs = f * moe["num_shared"]
            out += [("shared w13", 2 * fs, d, "dense"), ("shared w2", d, fs, "dense")]
    else:
        out += [("w13", 2 * shape["d_ff"], d, "dense"), ("w2", d, shape["d_ff"], "dense")]
    return out


def _top_k(shape: dict) -> int:
    return shape["moe"]["top_k"] if shape.get("moe") else 1


def projections(shape: dict, quant: dict, rows: int, gqmm_only: bool = False,
                decode: bool = False) -> Work:
    """Every projection of one forward pass over ``rows`` token rows that
    share one read of the weights: each layer's, routed experts at top_k a
    token and top_k a layer, and the classifier. With ``gqmm_only`` and
    ``decode``, MLA's ``wukv`` is left out: a decode step applies it to the
    query and the attention output (absorbed), not as a projection of
    quantized activations."""
    pref, fmt = quant["group_size"], quant["format"]
    k = _top_k(shape)
    total = Work()
    for name, m, n, kind in layer_projections(shape):
        if gqmm_only and decode and name == "wukv":
            continue
        one = projection(m, n, rows, group_size(n, pref), fmt)
        total = total + (one.scaled(k) if kind == "routed" else one)
    total = total.scaled(shape["num_layers"])
    d = shape["d_model"]
    vp = -(-shape["vocab_size"] // 32) * 32
    return total + projection(vp, d, rows, group_size(d, pref), fmt)


def _kv_row_bytes(shape: dict) -> int:
    """Cache bytes of one token in one layer: K and V rows, or MLA's latent
    and RoPE key."""
    mla = shape.get("mla")
    if mla:
        return ACT_BYTES * (mla["kv_lora_rank"] + mla["qk_rope_dim"])
    hd = shape.get("head_dim") or shape["d_model"] // shape["num_heads"]
    return ACT_BYTES * 2 * shape["num_kv_heads"] * hd


def _attention_ops(shape: dict, pairs: int, decode: bool) -> int:
    """bf16 operations of one layer's attention over ``pairs`` visible
    (query, key) pairs: q.k and p.v. MLA decodes over the latent (absorbed:
    kv_lora_rank + rope for the scores, kv_lora_rank for the values) and
    prefills over materialised heads (nope + rope, then v)."""
    h = shape["num_heads"]
    mla = shape.get("mla")
    if mla:
        if decode:
            return 2 * h * pairs * (2 * mla["kv_lora_rank"] + mla["qk_rope_dim"])
        return 2 * h * pairs * (mla["qk_nope_dim"] + mla["qk_rope_dim"] + mla["v_head_dim"])
    hd = shape.get("head_dim") or shape["d_model"] // h
    return 4 * h * hd * pairs


def prefill(shape: dict, quant: dict, lengths: list[int], gqmm_only: bool = False) -> Work:
    """Prefills of prompts of true ``lengths`` that share one read of the
    weights: every projection of their tokens, causal attention over each
    prompt's pairs, and the cache rows written. ``gqmm_only``: the
    projections alone."""
    tokens = sum(lengths)
    work = projections(shape, quant, tokens, gqmm_only)
    if gqmm_only:
        return work
    layers = shape["num_layers"]
    pairs = sum(s * (s + 1) // 2 for s in lengths)
    return work + Work(layers * tokens * _kv_row_bytes(shape), 0,
                       layers * _attention_ops(shape, pairs, decode=False))


def decode(shape: dict, quant: dict, steps: int, contexts: list[int],
           gqmm_only: bool = False) -> Work:
    """``steps`` decode steps that together produce one token for each entry
    of ``contexts``, the number of cache rows (its own included) that
    token's step attends over. Each step reads the weights once; each token
    adds its activations, its projections' operations, its attention over
    its context and the cache rows it reads and writes. ``gqmm_only``: the
    projections alone."""
    rows = len(contexts)
    if not steps or not rows:
        return Work()
    per_step = projections(shape, quant, 0, gqmm_only, decode=True)
    per_row = projections(shape, quant, 1, gqmm_only, decode=True) + per_step.scaled(-1)
    work = per_step.scaled(steps) + per_row.scaled(rows)
    if gqmm_only:
        return work
    layers, ctx = shape["num_layers"], sum(contexts)
    return work + Work(layers * (ctx + rows) * _kv_row_bytes(shape), 0,
                       layers * _attention_ops(shape, ctx, decode=True))


def request_contexts(prompt: int, tokens: int) -> list[int]:
    """Contexts of the decode steps that produce a request's tokens after
    the first (which its prefill produces): the j-th decoded token's step
    attends over prompt + j rows."""
    return [prompt + j for j in range(1, tokens)]
