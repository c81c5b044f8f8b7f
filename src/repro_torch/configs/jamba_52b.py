"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave
[arXiv:2403.19887; hf]. Attention sits at index 3 of each 8-layer period;
MoE on odd layers. The Mamba mixer uses our Mamba2/SSD block (DESIGN.md
notes the Mamba-1 -> SSD substitution)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, act="swiglu",
    num_experts=16, experts_per_tok=2, moe_d_ff=14336,
    moe_every=2, moe_offset=1, attn_period=8, attn_offset=3,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    moe_group_size=4096, fsdp_params=True,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, act="swiglu",
    num_experts=4, experts_per_tok=2, moe_d_ff=256,
    moe_every=2, moe_offset=1, attn_period=8, attn_offset=3,
    ssm_state=32, ssm_expand=2, ssm_head_dim=32, ssm_chunk=64,
    moe_group_size=64, capacity_factor=8.0,
)
