"""Where the program keeps what it makes at run time: inside the checkout.

Rendered frame sequences, trained vocabularies and profiler traces go
under DATA_DIR (`<checkout>/.bench_data`, listed in .gitignore), so
`bench.py`, `chip_smoke.py` and `scripts/` find each other's files and
nothing is written around the checkout.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(CHECKOUT, ".bench_data")


def data_path(name: str) -> str:
    """`DATA_DIR/name`, with its parent directory created."""
    path = os.path.join(DATA_DIR, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path
