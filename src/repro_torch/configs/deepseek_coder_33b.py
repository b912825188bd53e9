"""deepseek-coder-33b [dense]: llama-arch GQA [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    model_type="decoder_lm",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
