"""The benchmark's CPU tests: ``python -m pytest port_bench/tests -q`` from
the repository root. The harness's modules import as the benchmark's run
imports them (port_bench/ and the root on the path)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
