"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>
    python3 -m portbench ...          (the same)
    python3 portbench/run.py --list   (every cell and the files found for it)

From the root of a checkout. Loads, warms up, measures for ``--seconds``
(default: ``run_seconds`` of ``BENCHMARK.json``), checks what the window
produced against the plain reference, and prints one JSON line last on
standard output. Without a CUDA card it exits with 3 and prints no
result. The program builds its kernel libraries under the checkout
(``raytpu_torch/_build``, a fixed path), so a second run in the same
checkout builds nothing; the program uses no other kernel cache.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T_START)


if __name__ == "__main__":
    raise SystemExit(main())
