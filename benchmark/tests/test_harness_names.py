"""`BENCHMARK.json` keeps to the contract's names, and every name it uses
has its file."""

import os
import re

import pytest

from harness import spec

B = spec.bench_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
    names += [w["config"] for w in B["workloads"]] + [w["traffic"] for w in B["workloads"]]
    names += [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    names += [k for c in B["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["source"] for c in B["configs"]] + [x["why"] for x in B["configs"] + B["workloads"]] \
            + [m["layer"] for m in B["per_layer"]] + B["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique():
    for group in (B["configs"], B["workloads"], B["end_to_end"] + B["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def test_end_to_end_metrics():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_has_its_files():
    for w in B["workloads"]:
        cell = spec.load_cell(w["name"])
        assert w["chips"] in (1, 4)
        assert cell.traffic["loop"] and os.path.isfile(os.path.join(spec.BENCH_DIR, "loops",
                                                                    cell.traffic["loop"] + ".py"))
        assert set(cell.limits) == {"latent_rel_l2", "pcm_rel_l2"}
        e2e = [m for m in cell.end_to_end if m["name"] != "setup_s"]
        assert e2e and cell.per_layer, w["name"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics", m["name"] + ".py")), m["name"]


def test_per_layer_metrics_name_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in B["workloads"]]):
            assert "workloads" not in target or cell in target["workloads"], (m["name"], cell)


def test_configuration_files_state_no_reduction():
    for c in B["configs"]:
        assert c["file"].startswith("benchmark/")
        data = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert data["reduced"] == c["reduced"] == []


@pytest.mark.parametrize("name", [m["name"] for m in B["end_to_end"] + B["per_layer"]])
def test_every_reader_loads(name):
    assert callable(spec.load_module("metrics", name).read)
