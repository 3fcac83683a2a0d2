"""Run one cell of the port's benchmark (see ``portbench/harness.py``).

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
