"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit (also the last lines of standard error). Without the
CUDA devices the cell asks for, or with a JAX module loaded, it exits
with another code than 0 and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
