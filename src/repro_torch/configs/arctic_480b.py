"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].
128 experts shard cleanly over the model axis; attention heads (56) are not
divisible by 16 and replicate (see DESIGN.md §5). Dense-residual FFN runs in
parallel with the MoE on every layer (Arctic's dense+MoE hybrid)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, act="swiglu",
    num_experts=128, experts_per_tok=2, moe_d_ff=4864, dense_residual=True,
    moe_group_size=1024, fsdp_params=True,
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, act="swiglu",
    num_experts=8, experts_per_tok=2, moe_d_ff=128, dense_residual=True,
    moe_group_size=64,
    capacity_factor=8.0,
)
