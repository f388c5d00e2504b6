"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root (on a card, ``-m cuda`` runs the control at a size a
test can hold). They import the port on the CPU, at small sizes."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
