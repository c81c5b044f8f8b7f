"""Composable model library of the port: GQA transformers, MoE,
Mamba2/SSD and hybrids as nests of tensors and plain PyTorch functions,
layer-stacked per period position as the reference's
(``src/repro/models``), and the encoder-decoder family (``encdec``)."""
from .common import ModelConfig  # noqa: F401
from .registry import ModelApi, build  # noqa: F401
