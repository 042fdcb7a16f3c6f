"""Run one portbench cell once and print its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding BENCHMARK.json, portbench/ and
coherence_tpu_torch/.  See portbench/README.md."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
