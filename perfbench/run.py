"""Run one cell of the benchmark of ``sage3d_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output. See
``perfbench/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the host's numeric libraries run single-threaded
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
