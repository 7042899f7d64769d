"""The readers of the port's own spans and counters: their arithmetic on
synthetic records, nothing where the records do not line up with the
window or the port keeps none, and a traced CPU run of a per-mixture cell
at narrow widths that reports all five."""
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SPAN_METRICS = ("subdivide_s", "device_wait_s", "overlap_share",
                "geometry_s", "steering_table_s")
SEED = 2 ** 33 + 11


def _record(calls, spans=(), **counters):
    from acousticswarms_speech_tpu_torch.utils.spans import Record

    r = Record()
    r.counters["search.candidates"] = calls
    t = 0
    for name, seconds in spans:
        r.spans.append((name, None, t, t + int(seconds * 1e9)))
        t += int(seconds * 1e9)
    r.counters.update({k.replace("_", ".", 1): v
                       for k, v in counters.items()})
    return r


@pytest.fixture
def log(monkeypatch):
    """The port's log of records, as the test sets it."""
    from acousticswarms_speech_tpu_torch.utils import spans

    held = []
    monkeypatch.setattr(spans, "records", lambda: list(held))
    return held


def _run(*calls):
    return {"mixtures": [{"spot_calls": c, "stage_s": [0.0] * 5,
                          "array_setup_s": None} for c in calls]}


def _read(run):
    return {name: harness.read_metric(name, run) for name in SPAN_METRICS}


def test_readers_average_the_window(log):
    """A warm-up record first, then the window's two: per-mixture means of
    the spans, and the overlap's share over both."""
    log.append(_record(7, [("search.subdivide", 9.0)]))
    log.append(_record(300, [("array.geometry", 0.2),
                             ("array.steering_table", 0.6),
                             ("search.subdivide", 1.0),
                             ("device.wait", 0.5),
                             ("search.subdivide", 0.5)],
                       search_survivors=10, search_survivors_reused=1,
                       search_subdivided_overlap=2))
    log.append(_record(500, [("array.geometry", 0.4),
                             ("array.steering_table", 0.8),
                             ("device.wait", 2.5)],
                       search_survivors=10, search_survivors_reused=3,
                       search_subdivided_overlap=3))
    got = _read(_run(300, 500))
    assert got == pytest.approx({"subdivide_s": 0.75, "device_wait_s": 1.5,
                                 "overlap_share": 20.0, "geometry_s": 0.3,
                                 "steering_table_s": 0.7})


def test_fixed_array_reads_no_set_up(log):
    log.append(_record(300, [("device.wait", 1.0)], search_survivors=4))
    got = _read(_run(300))
    assert got == {"subdivide_s": 0.0, "device_wait_s": 1.0,
                   "overlap_share": 0.0, "geometry_s": None,
                   "steering_table_s": None}


@pytest.mark.parametrize("window", [(300, 501), (501, 300), (300, 500, 9)],
                         ids=["last_differs", "order_differs",
                              "more_mixtures_than_records"])
def test_records_not_of_the_window_read_nothing(log, window):
    log.append(_record(300, [("array.geometry", 0.2),
                             ("search.subdivide", 1.0)],
                       search_survivors=10, search_subdivided_overlap=2))
    log.append(_record(500, [("device.wait", 2.5)], search_survivors=10))
    assert set(_read(_run(*window)).values()) == {None}


def test_overlap_share_needs_sound_counts(log):
    log.append(_record(300, search_survivors=0))
    assert harness.read_metric("overlap_share", _run(300)) is None
    log.append(_record(300, search_survivors=5, search_survivors_reused=2,
                       search_subdivided_overlap=1))
    assert harness.read_metric("overlap_share", _run(300)) is None


def test_port_without_records_reads_nothing(monkeypatch):
    """A port that predates the records (the module is missing)."""
    monkeypatch.setitem(sys.modules,
                        "acousticswarms_speech_tpu_torch.utils.spans", None)
    assert set(_read(_run(300)).values()) == {None}
    assert set(_read(_run()).values()) == {None}


def test_traced_per_mixture_run_reports_them():
    """A traced CPU run of a per-mixture cell at narrow widths: every span
    metric read, the search's and the waits' inside the five stages, the
    set-up's inside the benchmark's own span around `setup`."""
    torch.set_num_threads(4)
    spec = tiny.spec(traffic_name="redeploy_3talkers", pool=3)
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    spec["per_layer"] = [m for m in manifest["per_layer"]
                         if m["name"] in SPAN_METRICS + ("array_setup_s",)]
    spec["per_layer"] += [{"name": f"{s}_s"} for s in
                          ("srp", "coarse", "fine", "clustering",
                           "separation")]
    for m in spec["per_layer"]:
        m.setdefault("unit", "s/mixture")
    result = harness.run_cell(spec, SEED, 0.01, True, "cpu",
                              time.perf_counter())
    assert result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPAN_METRICS) <= set(got)
    stages = sum(got[f"{s}_s"] for s in ("srp", "coarse", "fine",
                                          "clustering", "separation"))
    assert 0 < got["subdivide_s"] + got["device_wait_s"] <= stages
    assert 0 < got["geometry_s"] + got["steering_table_s"] \
        <= got["array_setup_s"]
    assert 0 <= got["overlap_share"] <= 100
