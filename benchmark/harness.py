"""One run of one cell: set-up, the measured window, the traced window's
per-layer reading, and the comparison with the plain reference.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration in `benchmark/configs/<config>.json`,
its traffic in `benchmark/traffic/<traffic>.json` (read by
`traffic/generator.py`), and each metric's reader in
`benchmark/metrics/<metric>.py`, a module with `read(run) -> float | None`
over the run's records (the dict `run_cell` builds: per-mixture stage
times, spot calls and set-up times, the window, the peak memory, the trace
summary, the roll kernel's launch shapes, the sweeps' and the separation's
call shapes, the configuration and the device's name).  A reader that
finds nothing to read returns None, and the metric is left out of the
result line.

The window is a closed loop: one `JointPipeline` takes the pool's
mixtures in turn, serially (with the traffic's `per_mixture` layout, its
`setup` first), until `seconds` have passed; the mixture in flight
finishes.  Rates are over all the time from the window's start to the last
completion.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from . import calibrate, check, nets, trace
from .reference.pipeline import ReferencePipeline
from .traffic import generator

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
GEOMETRY_CACHE = os.path.join(CACHE_DIR, "geometry")
# Mixtures the reference checks after the window: the one with the most
# spot calls and others drawn from the seed.
CHECKED = 2
# Top-level module names that must not be loaded when the result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "acousticswarms_speech_tpu")


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str, manifest: dict | None = None) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic and
    the metrics it reports (end-to-end and per-layer)."""
    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell,
            "config": load_json(BENCH_DIR, "configs", f"{cell['config']}.json"),
            "traffic": generator.load(cell["traffic"]),
            "end_to_end": mine(manifest["end_to_end"]),
            "per_layer": mine(manifest["per_layer"])}


def read_metric(name: str, run: dict):
    """metrics/<name>.py's reading of the run, or None."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(config: dict, device, control: str | None):
    """The port's JointPipeline for the configuration, with the weights
    the benchmark hands it.  `control` "bf16" switches on the port's
    bfloat16 path."""
    from acousticswarms_speech_tpu_torch.models import create_model
    from acousticswarms_speech_tpu_torch.models.weights import load_release
    from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline

    weights = config["weights"]
    nets_ = []
    for net in ("spotnet", "sepnet"):
        if weights["kind"] == "release":
            model = load_release(os.path.join(ROOT, weights[net]), device)
        else:
            spec = config[net]
            sd = nets.seeded_state_dict(spec["model_name"],
                                        spec["model_params"],
                                        weights["seeds"][net], device)
            with torch.device("meta"):
                model = create_model(spec["model_name"], spec["model_params"])
            model.load_state_dict(sd, strict=True, assign=True)
        nets_.append(model.eval())
    return JointPipeline(*nets_, device=device, use_bf16=control == "bf16",
                         sweep_crop_seconds=config["sweep_crop_seconds"])


class Recorder:
    """What the window's calls into the port took and gave, read by the
    benchmark's own wrappers around them: the stage-0 patches (copied, as
    the search narrows them later), and in a traced run the roll kernel's
    launch shapes, the sweeps' candidate shapes and the separation calls.
    The wrappers replace the port's functions on their classes and module
    for the run (`wrap`), so that no object of the port refers to them, and
    `unwrap` puts the port's own back.  A function that is gone fails the
    run, and `missing` names what the window did past the wrappers, which
    fails the comparison: the metrics read from these records would
    otherwise drop out or undercount while the work still ran."""

    def __init__(self, shapes: bool):
        self.shapes = shapes
        self.patches0 = None
        self.k1 = []
        self.sweeps = []
        self.sep = []
        self._restore = []
        self._k1_counter = None
        self._k1_before = 0

    def _replace(self, owner, name, make):
        if not hasattr(owner, name):
            raise RuntimeError(
                f"the port has no {getattr(owner, '__name__', owner)}.{name}, "
                f"which the benchmark reads its records through")
        orig = getattr(owner, name)
        self._restore.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def wrap(self) -> None:
        from acousticswarms_speech_tpu_torch.ops import shift
        from acousticswarms_speech_tpu_torch.pipeline.mic_array import \
            MicArray
        from acousticswarms_speech_tpu_torch.search import spotform

        def stage0(orig):
            def apply_srp_phat(mic_array, mix):
                out = orig(mic_array, mix)
                self.patches0 = [(p.sample_offset.copy(),
                                  p.width_list.copy()) for p in out[0]]
                return out
            return apply_srp_phat

        self._replace(MicArray, "apply_srp_phat", stage0)
        if not self.shapes:
            return

        def roll(orig):
            def roll_channels_batch_cuda(mix, shifts):
                self.k1.append((shifts.shape[0], *mix.shape))
                return orig(mix, shifts)
            return roll_channels_batch_cuda

        def sweep(orig):
            def sweep_(executor, input_channels, patch_list, *args, **kw):
                self.sweeps.append((len(patch_list), *input_channels.shape))
                return orig(executor, input_channels, patch_list, *args, **kw)
            return sweep_

        def separation(orig):
            def infer_sample(inference, input_channels, sample_list):
                self.sep.append((len(sample_list), *input_channels.shape))
                return orig(inference, input_channels, sample_list)
            return infer_sample

        self._replace(shift, "roll_channels_batch_cuda", roll)
        # the port counts the calls that launch the kernel on the function
        self._k1_counter = self._restore[-1][2]
        self._k1_before = self._k1_counter.launches
        self._replace(spotform._BatchedSweep, "sweep", sweep)
        self._replace(spotform.SeparationInference, "infer_sample",
                      separation)

    def missing(self, mixtures: list, outputs: dict) -> list[str]:
        """What the window's mixtures did that the wrappers did not see."""
        out = []
        lost = sum(outputs[m["index"]]["patches0"] is None for m in mixtures)
        if lost:
            out.append(f"stage-0 patches of {lost} mixtures "
                       f"(MicArray.apply_srp_phat)")
        if not self.shapes:
            return out
        swept = sum(s[0] for s in self.sweeps)
        counted = sum(m["spot_calls"] for m in mixtures)
        if swept != counted:
            out.append(f"sweeps (spotform._BatchedSweep.sweep): {swept} "
                       f"candidates recorded, {counted} counted by SweepLane")
        separated = sum(outputs[m["index"]]["audio"] is not None
                        for m in mixtures)
        if len(self.sep) != separated:
            out.append(f"separation calls (SeparationInference.infer_sample):"
                       f" {len(self.sep)} recorded, {separated} mixtures "
                       f"separated")
        launched = self._k1_counter.launches - self._k1_before
        if len(self.k1) != launched:
            out.append(f"roll kernel calls (shift.roll_channels_batch_cuda): "
                       f"{len(self.k1)} recorded, {launched} counted by the "
                       f"kernel's launcher")
        return out

    def unwrap(self) -> None:
        while self._restore:
            owner, name, orig = self._restore.pop()
            setattr(owner, name, orig)


def _program_record(pipe, out, patches0) -> dict:
    patches, audio_loc, audio = out[0], out[1], out[2]
    return {"srp_map": pipe.mic_processor.srp.srp_map, "patches0": patches0,
            "heads": check.heads_of(patches),
            "audio_loc": np.asarray(audio_loc) if len(patches) else None,
            "audio": None if audio is None else np.asarray(audio)}


def _setup_array(pipe, mics, roi, config, cache: bool) -> float:
    t0 = time.perf_counter()
    with torch.profiler.record_function("benchmark.array_setup"):
        pipe.setup(mics, roi, grid_size=config["grid_size"],
                   cache_dir=GEOMETRY_CACHE if cache else None)
    return time.perf_counter() - t0


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, control: str | None = None,
             first: int | None = None, least: int = 0) -> dict:
    """One run of the cell `spec` (see `cell_spec`).  Returns the result
    line's dict with the compared numbers under `check`, last.  `control`
    names a sound variant or control of `calibrate.py`, switched on until
    the window has closed; `first` is the window's first mixture (by
    default the one after the warm-up's), and the window runs on past
    `seconds` until `least` mixtures have ended."""
    config, traffic = spec["config"], spec["traffic"]
    device = torch.device(device)
    per_mixture = traffic["layout"] == "per_mixture"
    undo = calibrate.depart(control)

    pipe = build_program(config, device, control)
    log(f"networks ready at {time.perf_counter() - t_start:.2f}s")
    pool = generator.make_pool(traffic, config, device)
    log(f"{len(pool)} mixtures ready at {time.perf_counter() - t_start:.2f}s")
    recorder = Recorder(shapes=trace_on)
    if not per_mixture:
        _, mics, roi = pool.take(0)
        _setup_array(pipe, mics, roi, config, cache=True)
    # warm-up: every mixture of it first in the pool, each array set up
    warm = []
    for i in range(pool.warmup):
        mix, mics, roi = pool.take(i)
        if per_mixture:
            _setup_array(pipe, mics, roi, config, cache=False)
        t0 = time.perf_counter()
        pipe.forward(mix)
        sync(device)
        warm.append(time.perf_counter() - t0)
    setup_s = time.perf_counter() - t_start
    before_last = setup_s - warm[-1] if warm else 0.0
    if device.type == "cuda" and warm and warm[-1] >= before_last:
        raise RuntimeError(f"warm-up miss: the last warm-up forward took "
                           f"{warm[-1]:.2f}s, everything before it "
                           f"{before_last:.2f}s")
    log(f"set-up {setup_s:.2f}s (warm-up forwards "
        f"{[round(x, 2) for x in warm]})")

    recorder.wrap()
    mixtures, outputs, failed = [], {}, 0
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace_on:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    i = start = pool.warmup if first is None else first
    with torch.profiler.record_function(trace.WINDOW_SPAN):
        t0 = time.perf_counter()
        t_last = t0
        while (time.perf_counter() - t0 < seconds
               or len(mixtures) + failed < least):
            mix, mics, roi = pool.take(i)
            rec = {"index": i, "array_setup_s": None,
                   "started_at": time.perf_counter() - t0}
            recorder.patches0 = None
            try:
                if per_mixture:
                    rec["array_setup_s"] = _setup_array(
                        pipe, mics, roi, config, cache=False)
                calls = pipe.spot_model.calls
                ts = time.perf_counter()
                out = pipe.forward(mix)
                sync(device)
            except Exception:  # noqa: BLE001 (a failed mixture is counted)
                traceback.print_exc()
                failed += 1
                i += 1
                continue
            t_last = time.perf_counter()
            rec.update(forward_s=t_last - ts, done_at=t_last - t0,
                       stage_s=list(pipe.times),
                       spot_calls=pipe.spot_model.calls - calls)
            outputs[i] = _program_record(pipe, out, recorder.patches0)
            outputs[i]["spot_calls"] = rec["spot_calls"]
            mixtures.append(rec)
            i += 1
    window_s = t_last - t0
    attempted = i - start
    recorder.unwrap()
    undo()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window: {len(mixtures)} mixtures in {window_s:.3f}s "
        f"({attempted} started, {failed} failed), forwards "
        f"{[round(m['forward_s'], 2) for m in mixtures]}, peak {peak} bytes")
    if mixtures:
        # how near the window's end came to taking one mixture more or less
        log(f"window margin: the last mixture started at "
            f"{mixtures[-1]['started_at']:.3f}s and ended at "
            f"{mixtures[-1]['done_at']:.3f}s, the window {seconds:.3f}s")
    missing = recorder.missing(mixtures, outputs)
    for what in missing:
        log(f"not recorded: {what}")
    summary = None
    if prof is not None:
        from acousticswarms_speech_tpu_torch.pipeline.joint import STAGES

        spans = set(STAGES) | {"benchmark.array_setup"}
        summary = trace.summarize(trace.profiler_events(prof, spans), spans)
        del prof
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the reference runs in the configuration's precision, whatever the
    # control did
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    run = {"mixtures": mixtures, "window_s": window_s, "setup_s": setup_s,
           "peak_bytes": peak, "trace": summary, "k1_launches": recorder.k1,
           "sweeps": recorder.sweeps, "sep_calls": recorder.sep,
           "config": config,
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    names = [m["name"] for m in
             (spec["per_layer"] if trace_on else spec["end_to_end"])]
    units = {m["name"]: m["unit"] for m in
             spec["per_layer"] + spec["end_to_end"]}
    metrics = {}
    for name in names:
        value = read_metric(name, run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    numbers = verify(config, traffic, pool, outputs, mixtures, seed, device)
    limits = config["limits"]
    correct = (failed == 0 and bool(mixtures) and numbers is not None
               and check.judge(numbers, limits) and not missing)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                         "kind": run["device_name"], "count": 1,
                         "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["check"] = {k: {"value": (None if numbers is None
                                     else numbers[k]), "limit": limits[k]}
                       for k in check.NUMBERS}
    result["check"]["records_missing"] = {"value": len(missing), "limit": 0}
    return result


def verify(config, traffic, pool, outputs, mixtures, seed, device):
    """The worst numbers of `check` over the mixtures checked, worked out
    again by the plain reference once the window has closed (None when no
    mixture finished).  It checks the finished mixture with the most spot
    calls and CHECKED - 1 others drawn from the seed."""
    if not mixtures:
        return None
    done = [m["index"] for m in mixtures]
    first = max(mixtures, key=lambda m: m["spot_calls"])["index"]
    rest = [k for k in done if k != first]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    chosen = [first] + [int(k) for k in rng.permutation(rest)[:CHECKED - 1]]
    t0 = time.perf_counter()
    spot, sep = nets.reference_networks(config, ROOT, device)
    ref = ReferencePipeline(spot, sep, device=device,
                            sweep_crop_seconds=config["sweep_crop_seconds"])
    readings, layout = [], None
    for k in sorted(chosen):
        mix, mics, roi = pool.take(k)
        key = (np.asarray(mics).tobytes(), tuple(roi))
        if key != layout:
            ref.setup(mics, roi, grid_size=config["grid_size"])
            layout = key
        r = ref.forward(mix)
        r["heads"] = check.heads_of(r["heads"])
        readings.append(check.compare(outputs[k], r))
    log(f"reference checked mixtures {sorted(chosen)} in "
        f"{time.perf_counter() - t0:.2f}s")
    return check.worst(readings)
