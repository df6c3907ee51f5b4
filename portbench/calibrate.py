"""Readings that ``correct``'s limits are set from: see
``harness/calibrate.py``.  Run on the card from the checkout's root."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.calibrate import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main())
