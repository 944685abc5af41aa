"""Puts the benchmark's modules and the program's checkout on sys.path for
the tests beside this file (the harness keeps its modules flat, as
``run.py`` loads them)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH / "models"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))
