"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

81L d_model=3584 32H (kv=32, head_dim=112) d_ff=14336 vocab=32000
ssm_state=64; one SHARED GQA+MLP block applied every 6 Mamba2 layers.
O(1) SSM state => runs the long_500k cell.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    model_type="zamba2",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4),
    shared_attn_every=6,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    sub_quadratic=True,
)
