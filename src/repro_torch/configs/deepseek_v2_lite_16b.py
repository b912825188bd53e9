"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + 2 shared + 64 routed
top-6 experts [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff=1408 (per expert) vocab=102400. All layers MoE
per the assigned spec (released model keeps layer 0 dense -- DESIGN.md).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    model_type="decoder_lm",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    group_size=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
