"""minicpm3-4b [dense]: MLA attention [hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA kv_lora=256, q_lora=768,
qk_nope=64, qk_rope=32, v_head=64.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm3-4b",
    family="dense",
    model_type="decoder_lm",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
