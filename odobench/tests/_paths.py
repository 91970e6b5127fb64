"""Puts the benchmark's folder and the checkout's root on sys.path, as
`python odobench/run.py` finds them."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
