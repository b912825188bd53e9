"""dbrx-132b [moe]: 16 experts top-4, fine-grained
[hf:databricks/dbrx-base; unverified].

40L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=10752 (per expert)
vocab=100352; MoE 16e top-4 on every layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    model_type="decoder_lm",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
