"""The benchmark's own CPU tests: `python -m pytest -q bench/tests` from the
repository root (they are not under the repository's `testpaths`)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
