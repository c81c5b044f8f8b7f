"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA cards:
node repair and degraded reads of CP-LRC stripes. ``run.py`` runs one
cell; ``BENCHMARK.json`` at the root of the repository lists them."""
