"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. The last line of standard output is the run's result (JSON);
the last lines of standard error are the numbers compared, each beside
its limit. Exits non-zero, with no result, without a card, outside a
checkout of the repository (``src/repro_torch`` is the system under test)
or where the process loaded JAX or the JAX package.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT            # the package, not this directory (its modules' names are the package's)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
