"""rwkv6-7b [ssm]: RWKV-6 "Finch" -- attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L d_model=4096 (64 heads x 64) d_ff=14336 vocab=65536. O(1) decode state
=> runs the long_500k cell (sub_quadratic=True).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    model_type="rwkv6",
    num_layers=32,
    d_model=4096,
    num_heads=64,
    num_kv_heads=0,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    sub_quadratic=True,
)
