"""internlm2-1.8b [dense]: GQA llama-arch [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    model_type="decoder_lm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
