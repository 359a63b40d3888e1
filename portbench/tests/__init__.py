"""CPU tests of the benchmark.  The port is imported from ``src/``, as
``run.py`` imports it."""

import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.append(_SRC)
