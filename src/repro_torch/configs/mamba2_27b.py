"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060]. d_ff=0: pure
Mamba2 blocks with no separate MLP."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280, act="swiglu",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512, act="swiglu",
    ssm_state=32, ssm_expand=2, ssm_head_dim=32, ssm_chunk=64,
)
