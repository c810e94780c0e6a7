#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on this machine's GPU:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` ``breakdown``;
``checks`` last) and each compared number beside its limit as the last lines
on standard error. Exits non-zero, printing no result, without enough CUDA
devices, without the program beside the benchmark, or if the JAX package
or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout: only a
# checkout's first run compiles (the program's own nvcc libraries go to
# its `build/`).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
