"""Tests of the benchmark's plumbing, on the CPU at tiny sizes.

They import neither JAX nor the JAX package, and are run from the root of
the repository with `python -m pytest bench_port/tests -q`; the test marked
`cuda` runs a cell on the card and skips without one.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
