"""CPU tests of the benchmark; those that need the card are marked
``cuda``. Run from the repository's root: ``python -m pytest -q
portbench/tests``. The program is imported from ``src/``."""
import sys
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
