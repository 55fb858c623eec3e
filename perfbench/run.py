"""Run one cell of the benchmark from the root of a checkout:

    python3 perfbench/run.py --workload keyless.hyrax --seed 7 --seconds 45 --trace 0

The last line of standard output is the result, one JSON object; the
numbers the correctness check compared are the last lines of standard
error and the result's last key. Without a CUDA card, or with fewer than
the cell asks for, it prints no result and exits with 2.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every cache of the program stays inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
