"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, window 1024, 128k context
[hf:google/gemma-3]. head_dim=240 (d_model/heads)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, act="swiglu",
    sliding_window=1024, local_global_period=6, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    num_layers=6, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, act="swiglu",
    sliding_window=32, local_global_period=6,
)
