"""The metric arithmetic on synthetic inputs: the window rate, the idle
share's union of intervals, the roll kernel's bytes and the operation
counts against FlopCounterMode."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness, trace
from benchmark.reference.weights import create_model
from benchmark.tests import tiny


def _run(**kw):
    run = {"mixtures": [], "window_s": 0.0, "setup_s": 1.0, "peak_bytes": 0,
           "trace": None, "k1_launches": [], "sweeps": [], "sep_calls": [],
           "config": tiny.config(), "device_name": "NVIDIA H100 80GB HBM3"}
    run.update(kw)
    return run


def _mixture(done_at, stages=(0.1, 0.2, 3.0, 0.05, 0.3), calls=300,
             array_setup_s=None):
    return {"done_at": done_at, "stage_s": list(stages), "spot_calls": calls,
            "forward_s": sum(stages), "array_setup_s": array_setup_s}


def test_rate_counts_the_mixture_in_flight():
    """The window ran 10 s, the third mixture finished at 12.4 s: three
    mixtures over 12.4 s, not two over 10."""
    run = _run(mixtures=[_mixture(4.0), _mixture(8.1), _mixture(12.4)],
               window_s=12.4)
    assert harness.read_metric("mixtures_per_s", run) == pytest.approx(
        3 / 12.4)
    assert harness.read_metric("mixtures_per_s", _run()) is None


def test_stage_metrics_and_counts():
    run = _run(mixtures=[_mixture(1.0, calls=300, array_setup_s=0.5),
                         _mixture(2.0, stages=(0.3, 0.2, 5.0, 0.05, 0.1),
                                  calls=500, array_setup_s=0.7)],
               window_s=2.0)
    assert harness.read_metric("srp_s", run) == pytest.approx(0.2)
    assert harness.read_metric("fine_s", run) == pytest.approx(4.0)
    assert harness.read_metric("spot_calls", run) == pytest.approx(400)
    assert harness.read_metric("array_setup_s", run) == pytest.approx(0.6)
    run["mixtures"][0]["array_setup_s"] = None
    run["mixtures"][1]["array_setup_s"] = None
    assert harness.read_metric("array_setup_s", run) is None


def _events(kernels, spans=(), window=(0, 1000)):
    ev = [(trace.WINDOW_SPAN, False, "user_annotation", *window)]
    ev += [(n, False, "user_annotation", s, e) for n, s, e in spans]
    ev += [(n, True, "kernel", s, e) for n, s, e in kernels]
    ev.append(("gpu_annot", True, "gpu_user_annotation", *window))
    return ev


def test_idle_share_is_one_minus_the_union():
    """Overlapping kernels count once, parts outside the window not at all;
    annotations on the device's timeline are not work."""
    ev = _events([("a", 100, 300), ("b", 200, 400), ("c", 600, 700),
                  ("d", 950, 1100), ("e", -50, 10)],
                 spans=[("time_coarse_spotform_s", 300, 450),
                        ("time_fine_spotform_s", 450, 900)])
    s = trace.summarize(ev, {"time_fine_spotform_s",
                             "time_coarse_spotform_s"})
    busy_ns = 300 + 100 + 50 + 10
    assert s["busy_s"] == pytest.approx(busy_ns * 1e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert harness.read_metric("device_idle_share", _run(trace=s)) == \
        pytest.approx(100 * (1 - busy_ns / 1000))
    # each gap is named by the span that holds its middle: the gap from
    # 400 to 600 starts in the coarse stage but lies mostly in the fine
    gaps = dict((round(g * 1e9), n) for n, g in s["idle_gaps"])
    assert gaps == {90: "between_stages", 200: "time_fine_spotform_s",
                    250: "time_fine_spotform_s"}
    assert s["device_ops"][0] == ["a", pytest.approx(200e-9)]
    assert trace.summarize(ev[1:], set()) is None


def test_roll_bytes_and_roofline():
    assert flops.roll_bytes(336, 7, 72000) == 4 * (7 * 72000 + 336 * 7) \
        + 4 * 336 * 7 * 72000
    need = flops.roll_bytes(336, 7, 72000)
    s = {"busy_s": 1.0, "window_s": 2.0, "device_ops": [], "idle_gaps": [],
         "kernel_s": {"roll_channels_kernel(float const*, ...)": 2 * need
                      / 3.35e12}}
    run = _run(trace=s, k1_launches=[(336, 7, 72000)])
    assert harness.read_metric("k1_roofline", run) == pytest.approx(50.0)
    assert harness.read_metric("k1_roofline",
                               _run(trace=s, device_name="cpu")) is None


def test_flops_equal_flop_counter_on_real_tensors():
    cfg = tiny.config()
    spot, sep = cfg["spotnet"], cfg["sepnet"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        create_model(spot["model_name"], spot["model_params"]).eval()(
            torch.randn(3, 7, 4096), torch.zeros(3, 2))
    assert flops.spotnet_flops(spot, 3, 7, 4096) == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        create_model(sep["model_name"], sep["model_params"]).eval()(
            torch.randn(1, 2 * 7, 4096), torch.tensor([2]))
    assert flops.sepnet_flops(sep, 2, 7, 4096) == fc.get_total_flops()


def test_flops_at_the_release_widths():
    """190.0 GFLOP for SpotNet on one candidate of (7, 72000) and 2328
    GFLOP for SepNet at 5 heads of (7, 144000)."""
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "release7.json")) as f:
        cfg = json.load(f)
    assert flops.spotnet_flops(cfg["spotnet"], 1, 7, 72000) / 1e9 == \
        pytest.approx(190.0, rel=1e-3)
    assert flops.sepnet_flops(cfg["sepnet"], 5, 7, 144000) / 1e9 == \
        pytest.approx(2328.3, rel=1e-3)


def test_mfu_over_the_window():
    cfg = tiny.config()
    run = _run(sweeps=[(10, 7, 4096)], sep_calls=[(2, 7, 4096)],
               window_s=0.5, config=cfg)
    total = flops.spotnet_flops(cfg["spotnet"], 10, 7, 4096) \
        + flops.sepnet_flops(cfg["sepnet"], 2, 7, 4096)
    assert harness.read_metric("forward_mfu", run) == pytest.approx(
        100 * total / 0.5 / 67e12)
