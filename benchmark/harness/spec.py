"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds the sizes) and a traffic mix (`traffic/<mix>.json`). Its
correctness limits are `limits/<cell>.json`; each per-layer metric's reader is
`metrics/<metric>.py`; each loop kind is `loops/<kind>.py`. A later cell or
metric is new files and entries, never an edit of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]  # the configuration file's contents
    traffic: Dict[str, Any]  # the traffic file's contents
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def bench_spec(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = bench_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name, w, config, traffic, limits, e2e, per_layer)


_MODULES: Dict[str, Any] = {}


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark's folder as a module, loaded
    once a process (names may hold dots, so not through the import system's
    package lookup)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if path not in _MODULES:
        mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]
