"""TinyLlama 1.1B -- the paper's own evaluation model (arXiv:2401.02385).

22L, d=2048, 32H (GQA kv=4), d_ff=5632, vocab=32000; GS=256 divides every
dim (paper SIII-A).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    model_type="decoder_lm",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
