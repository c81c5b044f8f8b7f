"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]. Experts (8) are not
divisible by the model axis (16): the sharding layer automatically falls
back to tensor-parallel expert FFNs (32768/16) — see the reference's
src/repro/dist/sharding.py."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, act="swiglu",  # GeGLU-gated experts: 3
    # matrices per expert -> 8*3*(6144*32768)*64 = 309B + attn = 314B total
    num_experts=8, experts_per_tok=2, moe_d_ff=32768,
    moe_group_size=4096, fsdp_params=True,
)

SMOKE = ModelConfig(
    name="grok1-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, act="gelu",
    num_experts=4, experts_per_tok=2, moe_d_ff=256, moe_group_size=64,
    capacity_factor=8.0,
)
