"""The import guard: no JAX, Flax or JAX package in the measured process,
and no import of the program from the plain reference.

Names are compared whole by their top-level part (before the first dot):
the port's `acestep_tpu_torch` is not the JAX package `acestep_tpu`.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "acestep_tpu")
PROGRAM = "acestep_tpu_torch"


def forbidden_modules(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(forbidden))


def reference_imports(folder: str, banned=(PROGRAM,) + FORBIDDEN) -> List[str]:
    """Every import statement under `folder` whose top-level name is banned."""
    bad = []
    for base, _dirs, files in os.walk(folder):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                bad += [f"{path}: {m}" for m in mods if m.split(".")[0] in banned]
    return bad
