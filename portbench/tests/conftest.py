"""The benchmark's own tests: CPU tests at tiny sizes, and ``cuda`` tests
that skip without a card.  On the card's machine, which has no JAX, run
them with ``--noconftest`` (the repository's root conftest imports JAX):

    python -m pytest --noconftest portbench/tests
"""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')
