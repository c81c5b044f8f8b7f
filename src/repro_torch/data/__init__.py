"""Data pipeline of the port: the reference's numpy batches, byte for byte."""
from .pipeline import DataConfig, SyntheticLM, make_pipeline  # noqa: F401
