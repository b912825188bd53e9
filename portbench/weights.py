"""Float weights of a configuration, drawn from ``--seed`` on the device.

The tree has the port's layout (``models/transformer.init_lm``): stacked
``(L, ...)`` layer leaves under ``layers``, fused ``wqkv`` / ``w13``
projections in the paper's (out, in) layout. Every leaf, and each layer of a
stacked leaf, is drawn by a generator of its own, seeded from the run's seed
and the leaf's path, so that any one slice can be drawn again alone: the
plain reference draws one layer at a time and never holds the whole float
tree. Nothing here imports the program.

``shape`` is the ``port`` group of a configuration file: the port's
``ModelConfig`` fields, with ``mla`` and ``moe`` as nested groups.
"""

from __future__ import annotations

import hashlib

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def vocab_padded(shape: dict) -> int:
    return -(-shape["vocab_size"] // 32) * 32


def head_dim(shape: dict) -> int:
    return shape.get("head_dim") or shape["d_model"] // shape["num_heads"]


def leaf_specs(shape: dict) -> dict[str, tuple[tuple[int, ...], bool, float, torch.dtype]]:
    """path -> (shape of one slice, stacked by layer, scale, dtype). A scale
    of 0 marks a norm weight (ones); other leaves are N(0, 1) * scale, the
    port's initialisation: 1/sqrt(in) for projections, 0.02 for the
    embedding."""
    d, h = shape["d_model"], shape["num_heads"]
    dt = DTYPES[shape.get("param_dtype", "float32")]
    vp = vocab_padded(shape)
    specs = {"embed": ((vp, d), False, 0.02, dt),
             "layers/att_norm": ((d,), True, 0.0, dt),
             "layers/ffn_norm": ((d,), True, 0.0, dt),
             "final_norm": ((d,), False, 0.0, dt),
             "classifier": ((vp, d), False, d ** -0.5, dt)}

    def proj(path, out_dim, in_dim, lead=()):
        specs[path] = ((*lead, out_dim, in_dim), True, in_dim ** -0.5, dt)

    mla = shape.get("mla")
    if mla:
        qk = mla["qk_nope_dim"] + mla["qk_rope_dim"]
        proj("layers/attn/wq", h * qk, d)
        proj("layers/attn/wdkv", mla["kv_lora_rank"] + mla["qk_rope_dim"], d)
        specs["layers/attn/kv_norm"] = ((mla["kv_lora_rank"],), True, 0.0, dt)
        proj("layers/attn/wukv", h * (mla["qk_nope_dim"] + mla["v_head_dim"]),
             mla["kv_lora_rank"])
        proj("layers/attn/wo", d, h * mla["v_head_dim"])
    else:
        hd = head_dim(shape)
        q, kv = h * hd, shape["num_kv_heads"] * hd
        proj("layers/attn/wqkv", q + 2 * kv, d)
        proj("layers/attn/wo", d, q)
    moe = shape.get("moe")
    if moe:
        e, f = moe["num_experts"], moe["d_expert"]
        specs["layers/mlp/router_w"] = ((e, d), True, d ** -0.5, torch.float32)
        proj("layers/mlp/experts/w13", 2 * f, d, (e,))
        proj("layers/mlp/experts/w2", d, f, (e,))
        if moe.get("num_shared"):
            fs = f * moe["num_shared"]
            proj("layers/mlp/shared/w13", 2 * fs, d)
            proj("layers/mlp/shared/w2", d, fs)
    else:
        proj("layers/mlp/w13", 2 * shape["d_ff"], d)
        proj("layers/mlp/w2", d, shape["d_ff"])
    return specs


def slice_seed(seed: int, path: str, layer: int | None) -> int:
    """A 63-bit generator seed for one leaf slice, from the run's seed."""
    digest = hashlib.sha256(f"{seed}/{path}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(shape: dict, seed: int, path: str, layer: int | None, device,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    """One leaf (``layer`` None) or one layer's slice of a stacked leaf, in
    the leaf's type (or ``dtype``)."""
    dims, _, scale, leaf_dt = leaf_specs(shape)[path]
    dt = dtype or leaf_dt
    if scale == 0.0:
        return torch.ones(dims, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(slice_seed(seed, path, layer))
    x = torch.randn(dims, generator=gen, device=device, dtype=leaf_dt)
    return x.mul_(scale).to(dt)


def _nest(tree: dict, path: str, value) -> None:
    *heads, last = path.split("/")
    for k in heads:
        tree = tree.setdefault(k, {})
    tree[last] = value


def build_tree(shape: dict, seed: int, device) -> dict:
    """The whole float tree, each stacked leaf filled layer by layer."""
    tree: dict = {}
    layers = shape["num_layers"]
    for path, (dims, stacked, _, dt) in leaf_specs(shape).items():
        if stacked:
            leaf = torch.empty((layers, *dims), dtype=dt, device=device)
            for i in range(layers):
                leaf[i] = draw(shape, seed, path, i, device)
        else:
            leaf = draw(shape, seed, path, None, device)
        _nest(tree, path, leaf)
    return tree
