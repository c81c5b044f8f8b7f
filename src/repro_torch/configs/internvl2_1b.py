"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT frontend is a STUB (patch embeddings provided by
input_specs); backbone is the Qwen2-style LM [arXiv:2404.16821; hf]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, qkv_bias=True, act="swiglu",
    frontend="patches", frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, qkv_bias=True, act="swiglu",
    frontend="patches", frontend_tokens=16,
)
