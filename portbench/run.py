"""Run one cell of the port's benchmark once; see ``portbench/harness.py``.

    python3 portbench/run.py --workload mamba2-prefill-2k --seed 7 \\
        --seconds 40 --trace 0
"""
import time

T0 = time.perf_counter()    # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the benchmark is the package ``portbench``; the program is under src/
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
