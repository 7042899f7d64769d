"""The port's re-tune path against the JAX package's, on the CPU: the
trace tools of scripts/ on committed traced runs, a traced evaluation with
narrow networks, the offline NMS replay against the live clustering, and
the tools that drive them (retune_release, run_eval_suite,
probe_sep_batch)."""
import contextlib
import io
import json
import math
import os
import runpy
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest

from acousticswarms_speech_tpu.models import SepNet as JaxSepNet
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.pipeline import evaluate as jax_evaluate
from acousticswarms_speech_tpu.pipeline.joint import JointPipeline as JaxPipeline
from acousticswarms_speech_tpu.search import power_trace as jax_power_trace
from acousticswarms_speech_tpu_torch.dsp.patch import Patch
from acousticswarms_speech_tpu_torch.models import SepNet, SpotNet
from acousticswarms_speech_tpu_torch.pipeline import evaluate
from acousticswarms_speech_tpu_torch.pipeline.joint import JointPipeline
from acousticswarms_speech_tpu_torch.scripts import (probe_sep_batch,
                                                     replay_nms,
                                                     retune_release,
                                                     run_eval_suite)
from acousticswarms_speech_tpu_torch.search import clustering, power_trace
from acousticswarms_speech_tpu_torch.utils.metrics import si_sdr
from test_torch_eval import (CROP_S, DEV, EVAL_SEP, EVAL_SPOT, GRID,
                             _assert_same_results, _results,
                             small_search)  # noqa: F401 (fixture)
from test_torch_pipeline import (SEP_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "acousticswarms_speech_tpu_torch"
# Traced runs of the TPU era: round 5's probe (no elect/split records) and
# round 8's split probe (tdoa_elect and tdoa_split records).
FOLDERS = [".results_r5_probe", ".results_r8_split"]
MODES = {
    "replay": ("replay_nms.py", []),
    "replay_devs": ("replay_nms.py", ["--devs"]),
    "replay_gate": ("replay_nms.py", ["--gate"]),
    "replay_elect": ("replay_nms.py", ["--elect"]),
    "replay_split": ("replay_nms.py", ["--split"]),
    "tune_thresholds": ("tune_thresholds.py", []),
    "analyze_probe": ("analyze_probe.py", []),
    "analyze_retention": ("analyze_retention.py", []),
}


def _stdout_of(run, argv) -> str:
    """What `run()` prints with sys.argv = argv."""
    out, saved = io.StringIO(), sys.argv
    sys.argv = list(argv)
    try:
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            # the analyzers' NaN medians, and runpy's note that a module
            # this file imported runs again as __main__
            warnings.simplefilter("ignore", RuntimeWarning)
            run()
    finally:
        sys.argv = saved
    return out.getvalue()


def _jax_tool(script, args) -> str:
    path = os.path.join(REPO, "scripts", script)
    return _stdout_of(lambda: runpy.run_path(path, run_name="__main__"),
                      [path, *args])


def _port_tool(script, args) -> str:
    module = f"{PKG}.scripts.{script[:-3]}"
    return _stdout_of(lambda: runpy.run_module(module, run_name="__main__",
                                               alter_sys=True),
                      [module, *args])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("folder", FOLDERS)
def test_trace_tools_match_jax(folder, mode):
    """Each trace tool of the port prints exactly what the JAX package's
    script prints, on a committed traced run (analyze_retention without
    --dataset)."""
    script, extra = MODES[mode]
    args = [os.path.join(REPO, folder), *extra]
    want = _jax_tool(script, args)
    assert want.strip()
    assert _port_tool(script, args) == want


# Trace record fields by how the two packages must agree (tolerances of
# test_traced_evaluate_matches_jax).
POWER_FIELDS = {"powers_win", "powers_with_dis", "sub_powers_win",
                "max_power_win", "max_power_full", "min_trigger_power2",
                "powers", "power"}
SISDR_FIELDS = {"sisdr", "sisdr_win", "pair_sisdr"}
POSITION_FIELDS = {"centers", "dis"}
EXACT_FIELDS = {"stage", "offsets", "n_passing", "n_kept", "cap",
                "n_truncated", "big_offset", "sub_offsets", "big_label",
                "n_sub", "n_pass_p2", "n_pass_trigger", "n_clusters", "i",
                "head", "label", "head_label", "by", "n_in", "n_out",
                "in_labels", "out_labels", "has_segments", "tdoa_dev",
                "elected_label", "head_dev", "elected_dev", "dev"}


def _assert_same_records(got, want, grid):
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w), w["stage"]
        for k, wv in w.items():
            where = (w["stage"], k)
            if k in EXACT_FIELDS:
                assert g[k] == wv, where
            elif k in POWER_FIELDS:
                np.testing.assert_allclose(g[k], wv, rtol=1e-4, atol=1e-6,
                                           err_msg=str(where))
            elif k == "pair_sisdr":
                assert (g[k] is None) == (wv is None), where
                if wv is None:
                    continue
                a, b = np.asarray(g[k]), np.asarray(wv)
                assert a.shape == b.shape, where
                off = ~np.eye(len(b), dtype=bool)
                assert np.abs(a - b)[off].max(initial=0) <= 0.01, where
                assert (np.diag(a) > 50).all() and (np.diag(b) > 50).all()
            elif k in SISDR_FIELDS:
                assert np.abs(np.subtract(g[k], wv)).max(initial=0) <= 0.01, \
                    where
            elif k in POSITION_FIELDS:
                assert np.abs(np.subtract(g[k], wv)).max(initial=0) <= grid, \
                    where
            else:
                raise AssertionError(f"unclassified trace field {where}")


def _live_heads_replayed(folder):
    """(scene, live heads, replayed heads, untested pairs) of every traced
    scene of `folder` that reached the NMS, the replay at the run's own
    settings."""
    with open(os.path.join(folder, "config.json")) as f:
        settings = replay_nms.live_settings(json.load(f))
    out = []
    for fp, _, summary, pairs in replay_nms.load_scenes(str(folder)):
        scene = os.path.basename(fp)[len("trace_"):-len(".json")]
        with open(os.path.join(folder, f"result_{scene}.json")) as f:
            res = json.load(f)
        n, _, _, _, missing, _ = replay_nms.replay(summary, pairs, **settings)
        out.append((scene, len(res["pred"]) + len(res["false_positive"]),
                    n, missing))
    return out


def test_traced_evaluate_matches_jax(tmp_path, small_search, monkeypatch):
    """evaluate_dataset of both packages with power tracing on, on two dev
    scenes with the narrow networks of tests/test_torch_eval.py (weights
    from seeds), a 0.25 s selection crop and a 0.1 m grid.

    - The results pass that file's checks (perm, counts and spot calls
      equal, heads within one grid cell, SI-SDR fields within 0.01 dB).
    - Each trace_*.json holds the same sample_offsets_gt and the same
      sequence of record stages.  Integer, label, offset and TDoA-deviation
      fields are equal; powers within rtol 1e-4 / atol 1e-6; SI-SDR values
      (pair, windowed, the NMS matrix) within 0.01 dB, but for the NMS
      matrix's diagonal (a signal against itself, rounding noise above
      90 dB that no rule reads), which must be above 50 dB in both;
      positions and distances (m) within one grid cell.
    - The port's replay_nms at the run's own NMS settings gives every scene
      its live head count, with every windowed test taken from the live
      pass; analyze_retention with --dataset (loudness read from the WAVs)
      prints on the JAX run's folder what the JAX script prints."""
    for mod in (power_trace, jax_power_trace):
        monkeypatch.setattr(mod, "ENABLED", True)
        mod.drain()
    scenes = ["00000", "00001"]
    spot, sep = SpotNet(**EVAL_SPOT), SepNet(**EVAL_SEP)
    jax_pipe = JaxPipeline(JaxSpotNet(**EVAL_SPOT), _seeded_weights(spot, 0),
                           JaxSepNet(**EVAL_SEP), _seeded_weights(sep, 1),
                           sweep_crop_seconds=CROP_S)
    port_pipe = JointPipeline(spot, sep, device="cpu",
                              sweep_crop_seconds=CROP_S)
    keep = set(scenes).__contains__
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want_counts = jax_evaluate.evaluate_dataset(
        jax_pipe, DEV, str(jax_dir), grid_size=GRID, sample_filter=keep)
    got_counts = evaluate.evaluate_dataset(
        port_pipe, DEV, str(port_dir), grid_size=GRID, sample_filter=keep)
    assert got_counts == want_counts

    results = {n: r for n, r in _results(port_dir).items()
               if not n.startswith("trace_")}
    want = _results(jax_dir)
    _assert_same_results(
        results, {n: r for n, r in want.items() if not n.startswith("trace_")},
        GRID)
    for scene in scenes:
        name = f"trace_{scene}.json"
        with open(port_dir / name) as f:
            got = json.load(f)
        w = want[name]
        assert got["sample_offsets_gt"] == w["sample_offsets_gt"]
        assert any(r["stage"] == "nms_summary" for r in w["records"])
        _assert_same_records(got["records"], w["records"], GRID)

    replayed = _live_heads_replayed(port_dir)
    assert [r[0] for r in replayed] == scenes
    for scene, live, n, missing in replayed:
        assert (n, missing) == (live, 0), scene

    args = [str(jax_dir), "--dataset", DEV]
    want = _jax_tool("analyze_retention.py", args)
    assert "rms=nan" not in want
    assert _port_tool("analyze_retention.py", args) == want


def _pair(pos, audio, power, tag, label=-1):
    p = Patch(np.zeros(6), [3.0] * 6, None, peak_pos=np.asarray(pos))
    return (p, audio, power, tag,
            {"audio_offset": np.zeros(6), "localization_offset": np.zeros(6)},
            label)


def _voiced(rng, T=30000, scale=0.3):
    env = np.clip(np.sin(2 * np.pi * 2.0 * np.arange(T) / 48000), 0, None)
    return rng.normal(size=T) * scale * env


def test_replay_matches_live_nms(monkeypatch):
    """tests/test_nms_replay.py's case through the port: the live greedy
    clustering's trace records (pair_sisdr, powers, centers, has_segments
    in nms_summary; one nms_pair per tested pair) replayed by the port's
    replay_nms at the live thresholds give the live head count and GT
    labels, every windowed test taken from the live pass."""
    monkeypatch.setattr(power_trace, "ENABLED", True)
    power_trace.drain()
    rng = np.random.default_rng(7)
    a, b, c = _voiced(rng), _voiced(rng), _voiced(rng)
    pairs = [
        _pair([1.0, 1.0, 0.3], a, 4.0, "0_0", label=0),
        # near-duplicate of the head: merges by the full-SI-SDR rule
        _pair([3.0, 3.0, 0.3], a + 1e-4 * rng.normal(size=len(a)), 3.0,
              "1_0", label=1),
        # distinct audio, distant position: survives as a second head
        _pair([4.0, 0.5, 0.3], b, 2.0, "2_0", label=2),
        # distinct audio but 0.2 m from the first head: merges by distance
        _pair([1.2, 1.0, 0.3], c, 1.0, "3_0"),
        # silent: dropped before clustering (has_segments False)
        _pair([0.5, 4.0, 0.3], np.zeros(30000), 0.5, "4_0"),
    ]
    sigs = [p[1] for p in pairs]
    mat = np.array([[si_sdr(x, y) for y in sigs] for x in sigs])
    _, final, _ = clustering.clustering_nms(pairs, pair_sisdr=mat)
    recs = power_trace.drain()

    summary = next(r for r in recs if r["stage"] == "nms_summary")
    assert summary["pair_sisdr"] is not None
    assert len(summary["powers"]) == len(summary["in_labels"])
    assert len(summary["centers"]) == len(summary["in_labels"])
    assert summary["has_segments"].count(False) == 1
    pair_recs = {(r["i"], r["head"]): r for r in recs
                 if r["stage"] == "nms_pair"}
    assert pair_recs
    n_heads, out_labels, _, _, missing, _ = replay_nms.replay(
        summary, pair_recs, clustering.NMS_SISDR_THRESHOLD,
        win_thr=clustering.NMS_WIN_THRESHOLD,
        win_thr2=clustering.NMS_WIN_THRESHOLD2,
        dis_thr=clustering.NMS_DIS_THRESHOLD,
        max_out=clustering.NMS_MAX_OUT)
    assert missing == 0
    assert n_heads == len(final)
    assert out_labels == {lab for lab in summary["out_labels"] if lab >= 0}


def test_probe_sep_batch_on_the_cpu(tmp_path, capsys):
    """The batch probe with a narrow separation network (two U-Net levels,
    50 ms crops) in a scratch experiment, sizes 1 and 2 on the CPU: one
    line per size, a finite step time, peak memory "n/a"."""
    with open(os.path.join(REPO, "experiments", "speech_separation",
                           "description.json")) as f:
        desc = json.load(f)
    desc["model_params"] = dict(SEP_SMALL, n_mics=7, stride_list=[4, 4])
    desc["train_set_params"]["crop_seconds"] = 0.05
    with open(tmp_path / "description.json", "w") as f:
        json.dump(desc, f)
    probe_sep_batch.main(["1", "2", "--experiment", str(tmp_path),
                          "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["B=1", "B=2"]
    for ln in lines:
        step = float(ln.split("step ")[1].split("s ")[0])
        assert math.isfinite(step) and step > 0, ln
        assert ln.endswith("peak memory n/a"), ln


def test_retune_and_eval_suite_need_a_card_without_jax(tmp_path):
    """retune_release and run_eval_suite default to cuda: without a card
    each raises before it reads the dataset or touches the results folder,
    and the process never imports jax, flax, optax, msgpack or the JAX
    package."""
    outs = [str(tmp_path / "retune"), str(tmp_path / "suite")]
    runs = [("retune_release", [outs[0], "--dataset", DEV]),
            ("run_eval_suite", ["--dataset", DEV, "--results_folder",
                                outs[1]])]
    code = (
        "import sys, runpy\n"
        f"for name, args in {runs!r}:\n"
        f"    sys.argv = [name] + args\n"
        "    try:\n"
        f"        runpy.run_module('{PKG}.scripts.' + name,"
        " run_name='__main__')\n"
        "    except RuntimeError as e:\n"
        "        print(name, 'raised:', e)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'flax', 'optax', 'msgpack', 'acousticswarms_speech_tpu')]\n"
        "print('bad:', bad)\n")
    os.makedirs(outs[0])
    marker = os.path.join(outs[0], "keep")
    open(marker, "w").close()
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for name, _ in runs:
        assert f"{name} raised: no CUDA device" in proc.stdout, proc.stdout
    assert "bad: []" in proc.stdout, proc.stdout
    assert os.path.exists(marker) and not os.path.exists(outs[1])


def test_retune_steps_are_the_shell_loop_on_port_modules():
    """The loop's steps are port modules with the flags and environment of
    scripts/round4_probe.sh and scripts/retune_release.sh: the traced probe
    (ACOUSTIC_TRACE_POWERS=1, SPOT_POWER_THRESHOLD1, --use_fp16
    --cached_init, the shard flags) in a child process, then analyze, the
    three analyzers and the replay in four modes in this process."""
    args = retune_release.parse_args(["out", "--dataset", "data",
                                      "--coarse_thr", "0.006"])
    assert (args.num_shards, args.shard_index, args.device) == (27, 0, None)
    out, data = os.path.abspath("out"), os.path.abspath("data")
    steps = retune_release.steps(args)
    assert all(s.module.startswith(PKG + ".") for s in steps)
    probe = steps[0]
    assert probe.module == f"{PKG}.pipeline.evaluate"
    assert probe.env == {"ACOUSTIC_TRACE_POWERS": "1",
                         "SPOT_POWER_THRESHOLD1": "0.006"}
    assert probe.argv[0] == data
    joined = " ".join(probe.argv)
    for flags in ("--use_fp16 --cached_init", "--num_shards 27",
                  "--shard_index 0", f"--results_folder {out}",
                  "experiments/speech_localization",
                  "experiments/speech_separation"):
        assert flags in joined, flags
    assert "--device" not in probe.argv
    assert [(s.module.rsplit(".", 1)[1], s.argv, s.env) for s in steps[1:]] == [
        ("analyze", [out], None), ("analyze_probe", [out], None),
        ("analyze_retention", [out, "--dataset", data, "--coarse_thr",
                               "0.006"], None),
        ("tune_thresholds", [out], None), ("replay_nms", [out], None),
        ("replay_nms", [out, "--devs"], None),
        ("replay_nms", [out, "--gate"], None),
        ("replay_nms", [out, "--elect"], None)]
    args = retune_release.parse_args(["--device", "cpu", "--num_shards", "16"])
    argv = retune_release.steps(args)[0].argv
    assert argv[-4:] == ["--shard_index", "0", "--device", "cpu"]
    assert "--num_shards 16" in " ".join(argv)
    assert args.dataset == os.path.join(REPO, ".speechdata_v1", "test")


def test_eval_suite_commands_are_port_modules():
    """run_eval_suite's children, as the JAX script's: first the port's
    bench (--device passed on), then the port's evaluate with the JAX
    script's flags (--use_fp16 --cached_init, the shard flags, and --device
    when given), then the port's analyze of the same folder; with
    --skip_bench, evaluate and analyze alone."""
    argv = ["--num_shards", "16", "--device", "cpu", "--results_folder", "res"]
    cmds = run_eval_suite.commands(run_eval_suite.parse_args(argv))
    assert [t for t, _ in cmds] == ["bench", "eval", "analyze"]
    assert cmds[0][1] == [sys.executable, "-m", f"{PKG}.scripts.bench",
                          "--device", "cpu"]
    args = run_eval_suite.parse_args(argv[:2])  # no --device
    assert run_eval_suite.commands(args)[0][1][2:] == [f"{PKG}.scripts.bench"]
    skipped = run_eval_suite.commands(run_eval_suite.parse_args(
        argv + ["--skip_bench"]))
    assert skipped == cmds[1:]
    cmds = skipped
    assert [t for t, _ in cmds] == ["eval", "analyze"]
    for _, cmd in cmds:
        assert cmd[:2] == [sys.executable, "-m"]
        assert cmd[2].startswith(PKG + ".pipeline.")
    ev = " ".join(cmds[0][1])
    for flags in ("--use_fp16 --cached_init", "--num_shards 16",
                  "--shard_index 0", "--device cpu",
                  "--results_folder " + os.path.abspath("res"),
                  "experiments/speech_localization",
                  "experiments/speech_separation"):
        assert flags in ev, flags
    assert cmds[1][1][2:] == [f"{PKG}.pipeline.analyze",
                              os.path.abspath("res")]
    assert "bench" not in " ".join(" ".join(c) for _, c in cmds)


@pytest.mark.parametrize("codes,want", [
    ({"bench": 1}, 1),
    ({"bench": 3, "eval": 2}, 2),
    ({"analyze": 4}, 4),
    ({}, 0),
])
def test_eval_suite_runs_on_after_a_failed_bench(monkeypatch, capsys, codes,
                                                  want):
    """Children stubbed with the given exit codes: a failed bench prints
    `bench FAILED`, evaluate and analyze still run, and the suite exits
    with the bench's code; a failed evaluate ends the suite with its own
    code before analyze."""
    ran = []

    def fake_run(cmd, cwd=None):
        title = {f"{PKG}.scripts.bench": "bench",
                 f"{PKG}.pipeline.evaluate": "eval",
                 f"{PKG}.pipeline.analyze": "analyze"}[cmd[2]]
        ran.append(title)
        assert cwd == REPO
        return subprocess.CompletedProcess(cmd, codes.get(title, 0))

    monkeypatch.setattr(run_eval_suite.subprocess, "run", fake_run)
    assert run_eval_suite.main(["--device", "cpu"]) == want
    assert ran == (["bench", "eval"] if "eval" in codes
                   else ["bench", "eval", "analyze"])
    err = capsys.readouterr().err
    assert ("bench FAILED" in err) == ("bench" in codes)


def test_retune_release_runs_every_step_and_stops_at_a_failure(
        monkeypatch, tmp_path):
    """retune_release on a copy of .results_r5_probe (the probe stubbed out
    to make the copy): every analyzer step runs, each prints what the tool
    prints alone, and the provenance lists the run's thresholds.  A step
    that fails stops the loop with its exit code: a stubbed step's 3, and
    analyze_probe's 1 on a folder without traces."""
    src = os.path.join(REPO, ".results_r5_probe")
    titles = [s.title for s in retune_release.steps(
        retune_release.parse_args([]))]

    def run(probe, fail=None):
        out = str(tmp_path / "out")
        ran = []
        real = retune_release.run_step

        def run_step(step):
            ran.append(step.title)
            if step.env is not None:
                probe(out)
                return 0
            return 3 if step.title == fail else real(step)

        monkeypatch.setattr(retune_release, "run_step", run_step)
        codes = []
        text = _stdout_of(lambda: codes.append(retune_release.main(
            [out, "--dataset", str(tmp_path / "none"), "--device", "cpu"])),
            ["retune_release"])
        return codes[0], ran, text

    code, ran, text = run(lambda out: shutil.copytree(src, out))
    assert code == 0 and ran == titles
    for t in titles:
        assert f"=== {t} ===" in text, t
    for args in (["--devs"], ["--gate"], ["--elect"], []):
        assert _port_tool("replay_nms.py", [str(tmp_path / "out"), *args]) \
            in text
    assert _port_tool("tune_thresholds.py", [str(tmp_path / "out")]) in text
    assert _port_tool("analyze_probe.py", [str(tmp_path / "out")]) in text
    assert "  SPOT_POWER_THRESHOLD1 = 0.004" in text
    assert "=== done" in text

    code, ran, text = run(lambda out: shutil.copytree(src, out),
                          fail="threshold tuner")
    assert code == 3 and ran == titles[:titles.index("threshold tuner") + 1]
    assert "probe provenance" not in text

    def results_only(out):
        shutil.copytree(src, out,
                        ignore=shutil.ignore_patterns("trace_*.json"))

    code, ran, _ = run(results_only)
    assert code == 1 and ran == titles[:titles.index("NMS probe") + 1]
