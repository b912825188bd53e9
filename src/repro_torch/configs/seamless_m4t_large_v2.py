"""seamless-m4t-large-v2 [audio]: enc-dec, multimodal [arXiv:2308.11596; hf].

24L encoder + 24L decoder, d_model=1024 16H (kv=16, head_dim=64) d_ff=8192
vocab=256206. Speech frontend is a STUB: the caller supplies precomputed
frame embeddings (b, s_enc, d_model) as ``batch["frames"]``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    model_type="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="frames",
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
