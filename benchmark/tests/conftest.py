"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root (CPU); the test marked ``cuda`` runs a cell on the
card and skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
