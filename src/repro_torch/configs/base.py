"""Model configuration dataclasses (counterpart of ``repro/configs/base.py``).

The fields, defaults and ``reduced()`` are the reference's, field for field,
so a config built here compares equal to the JAX one after ``asdict``. Only
``pdtype()``/``cdtype()`` differ: they return torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    model_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    gemma_norms: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_pattern: Optional[str] = None

    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    shared_attn_every: int = 0
    encoder_layers: int = 0

    frontend: Optional[str] = None
    num_frontend_tokens: int = 0

    group_size: int = 256                   # paper §III-A GS
    quant_format: str = "int8"
    kv_quant: Optional[str] = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    sub_quadratic: bool = False

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 32 (the reference's sharding pad)."""
        return ((self.vocab_size + 31) // 32) * 32

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's cut)."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            group_size=32,
            num_frontend_tokens=min(self.num_frontend_tokens, 4),
            encoder_layers=min(self.encoder_layers, 2),
            sliding_window=64 if self.sliding_window else None,
            shared_attn_every=2 if self.shared_attn_every else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.layer_pattern:
            changes["layer_pattern"] = self.layer_pattern[: changes["num_layers"]]
        if self.moe:
            changes["moe"] = MoEConfig(
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                num_shared=min(self.moe.num_shared, 1),
            )
        if self.mla:
            changes["mla"] = MLAConfig(
                kv_lora_rank=32,
                q_lora_rank=32 if self.mla.q_lora_rank else 0,
                qk_nope_dim=16,
                qk_rope_dim=16,
                v_head_dim=16,
            )
        if self.ssm:
            changes["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_kernel=4)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[self.kind]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}
