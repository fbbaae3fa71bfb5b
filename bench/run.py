"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout that holds ``BENCHMARK.json``, ``bench/``
and the port under ``src/repro_torch``.  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, and with ``--trace 1`` ``breakdown``); the numbers that decided
``correct`` are the last lines of standard error.  See ``bench/README.md``.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0, root=BENCH.parent))
