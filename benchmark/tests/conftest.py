"""Put the benchmark's folder, this folder and the repository's root on the
import path (the helpers here are imported by their bare module name: a
package named `tests` may be installed and would shadow this folder)."""

import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)
