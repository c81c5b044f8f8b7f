#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    PYTHONPATH=src python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared beside its limit);
the line before it holds the run's I/O counters from ``/proc/self/io``.
Without the cards it exits 2 and prints no result.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
