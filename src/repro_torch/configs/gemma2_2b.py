"""gemma2-2b [dense]: local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000;
sliding_window=4096 on alternating (L) layers; attn softcap 50, final
softcap 30; (1+w) RMSNorm with pre+post block norms; tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-2b",
    family="dense",
    model_type="decoder_lm",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    gemma_norms=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=256.0,
    sliding_window=4096,
    layer_pattern="LG",
    tie_embeddings=True,
    group_size=256,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
