"""pixtral-12b [vlm]: Pixtral ViT frontend (STUB) + Mistral-NeMo-style
backbone [hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
input_specs() supplies precomputed patch embeddings (b, 256, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    model_type="decoder_lm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="patch_embed",
    num_frontend_tokens=256,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
