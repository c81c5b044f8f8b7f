"""PyTorch/CUDA port of the CP-LRC stripe system.

A second package beside the JAX reference (``src/repro``): the same codec,
planner, stripe store and repair pipeline, with the byte crunching in a
CUDA kernel written by hand for Hopper (``csrc/``). It imports ``torch``
and numpy only, and keeps its own copies of the reference's numpy planning
modules; the ``tests/test_torch_*.py`` suite holds every piece to the
reference byte for byte.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
