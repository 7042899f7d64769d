"""Each configuration's limits follow from its readings on the card
(`benchmark/calibration/<config>.jsonl`, printed by `calibrate.py`) by
the rule in `check.py`: a limit changed without readings fails here."""
import json
import os

import pytest

from benchmark import calibrate, check, harness
from benchmark.tests.test_perfbench_control import SEEDS

MANIFEST = harness.load_json(harness.ROOT, "BENCHMARK.json")
CONFIGS = [c["name"] for c in MANIFEST["configs"]]
SOUND_SEEDS = 15  # seeds a cell for the timed path and each sound variant


def _lines(config):
    path = os.path.join(harness.BENCH_DIR, "calibration", f"{config}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _limits(config):
    return harness.load_json(harness.BENCH_DIR, "configs",
                             f"{config}.json")["limits"]


@pytest.mark.parametrize("config", CONFIGS)
def test_limits_follow_the_readings(config):
    assert _limits(config) == check.limits_from(_lines(config))


@pytest.mark.parametrize("config", CONFIGS)
def test_every_control_run_fails_by_the_margin(config):
    limits = _limits(config)
    controls = [r for r in _lines(config) if r["control"] in check.CONTROLS]
    assert controls
    for r in controls:
        assert not check.judge(r["numbers"], limits), r
        assert check.margin(r["numbers"], limits) >= check.MARGIN, r


@pytest.mark.parametrize("config", CONFIGS)
def test_every_sound_run_is_correct(config):
    """Every sound run is correct, but for one whose decisions differed
    from the reference's (PERF.md lists those runs)."""
    limits = _limits(config)
    for r in _lines(config):
        if r["control"] not in check.CONTROLS:
            assert r["failed"] == 0, r
            assert r["numbers"]["records_missing"] == 0, r
            assert (check.judge(r["numbers"], limits)
                    or check.decides_otherwise(r["numbers"])), r


@pytest.mark.parametrize("config", CONFIGS)
def test_the_readings_cover_every_cell(config):
    """Each cell of the configuration: the timed path and two sound
    variants or more on SOUND_SEEDS seeds or more, other than the control
    seeds; each control on the control seeds."""
    lines = _lines(config)
    cells = [w["name"] for w in MANIFEST["workloads"]
             if w["config"] == config]
    for cell in cells:
        seeds = {}
        for r in lines:
            if r["workload"] == cell:
                seeds.setdefault(r["control"], set()).add(r["seed"])
        variants = [c for c in calibrate.SOUND if c in seeds]
        assert len(variants) >= 2, (cell, sorted(seeds))
        for control in ["none"] + variants:
            assert len(seeds[control]) >= SOUND_SEEDS, (cell, control)
            assert not seeds[control] & set(SEEDS), (cell, control)
        for control in check.CONTROLS:
            assert seeds.get(control) == set(SEEDS), (cell, control)
    assert {r["workload"] for r in lines} <= set(cells)
