"""BENCHMARK.json against the rules of its format, and every file a cell
needs found by name."""
import json
import os
import re

import pytest

from benchmark import check, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for path in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    for word in manifest["command"][1:]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_a_full_check_fits(manifest):
    """2 + 14 runs a cell with the full 24 cells, each run_seconds + 60 s,
    2 x 90 s of compiling a cell and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    assert len(set(names)) == len(names)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert w["config"] in names
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


@pytest.mark.parametrize("cell", ["release7.fixed_array", "release7.new_array"])
def test_cell_files_found_by_name(manifest, cell):
    spec = harness.cell_spec(cell, manifest)
    assert len(spec["end_to_end"]) >= 2
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
    conf = next(c for c in manifest["configs"]
                if c["name"] == spec["cell"]["config"])
    assert conf["file"] == f"benchmark/configs/{conf['name']}.json"
    assert spec["config"]["n_mics"] == \
        spec["config"]["spotnet"]["model_params"]["n_mics"]
    assert set(spec["config"]["limits"]) == set(check.NUMBERS)
