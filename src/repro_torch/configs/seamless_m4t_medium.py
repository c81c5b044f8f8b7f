"""seamless-m4t-medium [audio]: enc-dec, 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596; hf]. The speech frontend is a
STUB per the assignment: input_specs() provides (B, T, d_model) frame
embeddings directly."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, encoder_layers=12, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=256206, act="gelu",
    frontend="frames",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=512, act="gelu",
    frontend="frames",
)
