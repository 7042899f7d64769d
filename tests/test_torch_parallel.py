"""The port's multi-device layer (parallel/) against its unsharded code and
against the JAX package's sharded functions, on the CPU.

The JAX side runs in this process on the virtual CPU devices of
tests/conftest.py.  The port's side runs in 2- or 4-rank gloo groups that
parallel.mesh.launch spawns with device="cpu"; the rank programs are those
of parallel/ranks.py (a spawned rank imports its target's module, and a
target here would pull JAX into every rank).  Several programs share one
launch, since every rank pays for importing torch."""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acousticswarms_speech_tpu.ops.srp import build_steering_table as jax_steering
from acousticswarms_speech_tpu.ops.srp import srp_phat_map as jax_srp_phat_map
from acousticswarms_speech_tpu.ops.stft import dft_bases
from acousticswarms_speech_tpu.models import SpotNet as JaxSpotNet
from acousticswarms_speech_tpu.parallel import mesh as jax_mesh
from acousticswarms_speech_tpu.search import spotform as jax_spotform
from acousticswarms_speech_tpu.training.train import make_step_fns as jax_make_step_fns
from acousticswarms_speech_tpu_torch.device import resolve_device
from acousticswarms_speech_tpu_torch.models import SpotNet
from acousticswarms_speech_tpu_torch.ops.srp import (build_steering_table,
                                                     srp_phat_map)
from acousticswarms_speech_tpu_torch.parallel import ranks
from acousticswarms_speech_tpu_torch.parallel.mesh import launch
from acousticswarms_speech_tpu_torch.pipeline.mic_array import MicArray
from acousticswarms_speech_tpu_torch.pipeline.throughput import PipelinedRunner
from acousticswarms_speech_tpu_torch.search import spotform
from acousticswarms_speech_tpu_torch.training.train import make_step_fns

from test_pipeline_e2e import MIC_POS, _make_scene
from test_torch_pipeline import (SPOT_SMALL, _seeded_weights,
                                 one_torch_thread)  # noqa: F401 (autouse)
from test_torch_training import _flat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

# SRP shapes of tests/test_parallel.py and tests/test_srp_time_shard.py
M_SRP, NFFT, WINDOW = 4, 256, 1024
BINS = np.arange(2, 12)
# the narrow SpotNet of tests/test_parallel.py::test_executor_mesh_equality
EXEC_SPOT = dict(n_mics=4, stride_list=(2, 2), channels=4, encoder_channels=8,
                 residual_layers=1, ffw_dim=8, num_transformer_layers=1,
                 num_head=2)
# the scene of tests/test_parallel.py::test_full_search_stack_mesh_equality
SCENE_SRCS = [np.array([4.8, 2.4, 0.4]), np.array([2.2, 3.4, 0.3])]
SCENE_ROI = [1.0, 6.0, 0.2, 5.0, 0.1, 0.62]
# the train step: the narrow SpotNet of tests/test_torch_training.py
STEP_SPOT = dict(SPOT_SMALL, stride_list=(4, 4))
STEP_LR, STEP_CLIP, STEP_T = 1e-3, 1.0, 4096
PERTURB = (0.05, 0.05)


def _srp_inputs(G, T, seed=0):
    rng = np.random.default_rng(seed)
    mic_pos = np.concatenate(
        [rng.uniform(-0.5, 0.5, size=(M_SRP, 2)), np.zeros((M_SRP, 1))], axis=1)
    grids = np.concatenate(
        [rng.uniform(-2, 2, size=(G, 2)), rng.uniform(0.1, 0.5, size=(G, 1))],
        axis=1)
    signal = rng.normal(size=(M_SRP, T)).astype(np.float32)
    return mic_pos, grids, signal


def _spec(model_params, model):
    return {"model_name": "SpeakerLocalization", "model_params": model_params,
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def _exec_case():
    """The narrow SpotNet's weights for both packages and the executor's
    inputs: 21 candidates (a multiple of neither 2 nor 4)."""
    model = SpotNet(**EXEC_SPOT)
    params = _seeded_weights(model, 0)
    rng = np.random.default_rng(0)
    mix = rng.normal(size=(4, 512)).astype(np.float32)
    cands = [rng.integers(-8, 8, size=3) for _ in range(21)]
    return model, params, mix, cands


def _step_case():
    """The narrow SpotNet and a batch of 4 whose targets are silent in rows
    1-3, so that the two ranks' halves hold 1 and 2 silent targets (the
    fused loss takes masked means over silent and voiced rows, so the mean
    of the halves' losses is not the batch's loss)."""
    model = SpotNet(**STEP_SPOT)
    params = _seeded_weights(model, 5)
    rng = np.random.default_rng(3)
    data = rng.normal(size=(4, 7, STEP_T)).astype(np.float32) * 0.1
    gt = rng.normal(size=(4, 1, STEP_T)).astype(np.float32) * 0.1
    gt[1:4] = 0.0
    cond = np.tile([[1.0, 0.0], [0.0, 1.0]], (2, 1)).astype(np.float32)
    return model, params, (data, gt, cond)


@pytest.fixture(scope="module")
def four_ranks():
    """One 4-rank launch: the grid- and time-sharded SRP maps, and the
    executor sweep of 21 candidates and of 3 (fewer than the ranks)."""
    mic_pos, grids, signal = _srp_inputs(64, 2048)
    tables = build_steering_table(grids, mic_pos, BINS, 48000, NFFT)
    step = WINDOW // 2
    slab_T = WINDOW + step
    t_mic, t_grids, t_signal = _srp_inputs(16, 4 * slab_T)
    slabs = np.ascontiguousarray(
        t_signal.reshape(M_SRP, 4, slab_T).transpose(1, 0, 2))
    t_tables = build_steering_table(t_grids, t_mic, BINS, 48000, NFFT)
    model, params, mix, cands = _exec_case()
    spec = _spec(EXEC_SPOT, model)
    calls = [
        (ranks.srp_grid, (signal, *tables, BINS, WINDOW, NFFT, NFFT // 4)),
        (ranks.srp_time, (slabs, *t_tables, BINS, WINDOW, NFFT, NFFT // 4)),
        (ranks.sweep, (spec, mix, cands, 0, True)),
        (ranks.sweep, (spec, mix, cands[:3], 1, True)),
    ]
    out = launch(ranks.sequence, 4, "gloo", "cpu", args=(calls,))
    return {"srp": (signal, tables, grids, mic_pos),
            "time": (slabs, t_tables, t_grids, t_mic),
            "exec": (model, params, mix, cands), "out": out}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank launch: the executor sweep, the delay-and-sum search
    stack on the scene of tests/test_parallel.py, and the train step with
    and without the noise augmentation."""
    model, params, mix, cands = _exec_case()
    scene, _ = _make_scene(SCENE_SRCS, seed=1)
    scene = scene.astype(np.float32)
    cache = str(tmp_path_factory.mktemp("geometry"))
    # the unsharded stack writes the geometry cache the ranks read
    arr = MicArray(MIC_POS, spk_range=SCENE_ROI, grid_size=0.05,
                   cache_dir=cache, device="cpu")
    executor = spotform.DelayAndSumExecutor(device="cpu")
    patches, _ = arr.apply_srp_phat(scene)
    big = arr.spotform_big_patch(scene, patches, executor)
    pairs = arr.spotform_small_patch_parallel(scene, big, executor)
    audio, heads, _, _ = arr.clustering_new(pairs)
    step_model, step_params, batch = _step_case()
    step_spec = _spec(STEP_SPOT, step_model)
    calls = [
        (ranks.sweep, (_spec(EXEC_SPOT, model), mix, cands, 0, True)),
        (ranks.search_stack, (scene, MIC_POS, SCENE_ROI, 0.05, cache)),
        (ranks.train_step, (step_spec, "fused", batch, None, None, STEP_CLIP,
                            STEP_LR)),
        (ranks.train_step, (step_spec, "fused", batch, 3, PERTURB, STEP_CLIP,
                            STEP_LR)),
    ]
    out = launch(ranks.sequence, 2, "gloo", "cpu", args=(calls,))
    return {"exec": (model, params, mix, cands),
            "stack": {"audio": audio,
                      "heads": [ranks.head_summary(h) for h in heads]},
            "step": (step_params, batch), "out": out}


def _same_on_all_ranks(out, index):
    first = out[0][index]
    for other in out[1:]:
        _assert_tree_equal(other[index], first)
    return first


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# --- case 1: grid-sharded SRP ------------------------------------------------

def test_grid_sharded_srp_matches_unsharded_and_jax(four_ranks):
    """4 cand ranks, G = 64: the map equals the port's unsharded map at
    rtol 1e-5 / atol 1e-6, and JAX shard_srp_map's within 1e-4 of the peak
    (torch.fft against the JAX package's matmul DFT)."""
    signal, (steer_re, steer_im), grids, mic_pos = four_ranks["srp"]
    got = _same_on_all_ranks(four_ranks["out"], 0)
    want = srp_phat_map(torch.from_numpy(signal), torch.from_numpy(steer_re),
                        torch.from_numpy(steer_im), torch.from_numpy(BINS),
                        WINDOW, NFFT, NFFT // 4).numpy()
    assert got.shape == (64,) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    j_re, j_im = jax_steering(grids, mic_pos, BINS, 48000, NFFT)
    cos_b, sin_b = (jnp.asarray(b) for b in dft_bases(NFFT, BINS))
    mesh = jax_mesh.make_mesh(n_data=1, n_cand=4, devices=jax.devices()[:4])
    fn = jax_mesh.shard_srp_map(mesh, lambda s, re, im, cb, sb: jax_srp_phat_map(
        s, re, im, cb, sb, window=WINDOW, nfft=NFFT, hop=NFFT // 4))
    with mesh:
        jax_map = np.asarray(fn(jnp.asarray(signal), j_re, j_im, cos_b, sin_b))
    np.testing.assert_allclose(got, jax_map, atol=1e-4 * jax_map.max())


# --- case 2: time-sharded SRP ------------------------------------------------

def test_time_sharded_srp_matches_per_slab_max_and_jax(four_ranks):
    """4 slabs of two analysis windows each: the MAX all-reduce equals the
    max of the per-slab maps at rtol 1e-5 / atol 1e-6, and JAX
    srp_time_sharded's at the same tolerance."""
    slabs, (steer_re, steer_im), grids, mic_pos = four_ranks["time"]
    got = _same_on_all_ranks(four_ranks["out"], 1)
    want = np.max([srp_phat_map(torch.from_numpy(s), torch.from_numpy(steer_re),
                                torch.from_numpy(steer_im),
                                torch.from_numpy(BINS), WINDOW, NFFT,
                                NFFT // 4).numpy() for s in slabs], axis=0)
    assert got.shape == (16,) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    j_re, j_im = jax_steering(grids, mic_pos, BINS, 48000, NFFT)
    cos_b, sin_b = (jnp.asarray(b) for b in dft_bases(NFFT, BINS))
    mesh = jax_mesh.make_mesh(n_data=1, n_cand=4, devices=jax.devices()[:4])
    fn = jax_mesh.srp_time_sharded(mesh)(WINDOW, NFFT, NFFT // 4)
    with mesh:
        jax_map = np.asarray(fn(jnp.asarray(slabs), j_re, j_im, cos_b, sin_b))
    np.testing.assert_allclose(got, jax_map, rtol=1e-5, atol=1e-6)


# --- case 3: the candidate-sharded executor ---------------------------------

def _assert_sweep_matches_unsharded(got, model, mix, cands, strict):
    want = spotform.SpotformExecutor(model, device="cpu").sweep(
        mix, cands, strict=strict, with_similarity=True)
    np.testing.assert_allclose(got["powers"], want.powers, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["powers_win"], want.powers_win, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["sisdr_mat"], want.sisdr_mat, rtol=1e-4,
                               atol=1e-5)
    rows = want.gather(range(len(cands)), quantize=False)
    assert got["waveforms"].shape == (len(cands), mix.shape[1])
    for k in range(len(cands)):
        np.testing.assert_allclose(got["waveforms"][k], rows[k], rtol=1e-5,
                                   atol=1e-6)


def _assert_sweep_matches_jax(got, params, mix, cands, strict):
    """The tolerances of test_torch_search.py::test_spotnet_sweep_matches_jax
    against JAX SpotformExecutor(mesh=make_mesh(1, 2))."""
    mesh = jax_mesh.make_mesh(n_data=1, n_cand=2, devices=jax.devices()[:2])
    want = jax_spotform.SpotformExecutor(JaxSpotNet(**EXEC_SPOT), params,
                                         mesh=mesh).sweep(
        mix, cands, strict=strict, with_similarity=True)
    np.testing.assert_allclose(got["powers"], want.powers, rtol=1e-4)
    np.testing.assert_allclose(got["powers_win"], want.powers_win, rtol=1e-4)
    np.testing.assert_allclose(got["sisdr_mat"], want.sisdr_mat, atol=1e-2)
    rows = want.gather(range(len(cands)), quantize=False)
    for k in range(len(cands)):
        np.testing.assert_allclose(got["waveforms"][k], rows[k],
                                   atol=1e-4 * np.abs(rows[k]).max())


@pytest.mark.parametrize("n_cand", [2, 4])
def test_sharded_executor_matches_unsharded_and_jax(n_cand, four_ranks,
                                                    two_ranks):
    """21 candidates over 2 and 4 cand ranks (padded to 22 and 24), with the
    SI-SDR matrix: every rank holds the unsharded sweep's result."""
    case = two_ranks if n_cand == 2 else four_ranks
    model, params, mix, cands = case["exec"]
    got = _same_on_all_ranks(case["out"], 0 if n_cand == 2 else 2)
    _assert_sweep_matches_unsharded(got, model, mix, cands, 0)
    _assert_sweep_matches_jax(got, params, mix, cands, 0)


def test_sharded_executor_fewer_candidates_than_ranks(four_ranks):
    """3 candidates on 4 ranks: the last rank's slice is all padding and it
    still joins the gathers."""
    model, params, mix, cands = four_ranks["exec"]
    got = _same_on_all_ranks(four_ranks["out"], 3)
    assert got["powers"].shape == (3,) and got["sisdr_mat"].shape == (3, 3)
    _assert_sweep_matches_unsharded(got, model, mix, cands[:3], 1)
    _assert_sweep_matches_jax(got, params, mix, cands[:3], 1)


# --- case 4: the whole search stack ------------------------------------------

def test_search_stack_matches_unsharded(two_ranks):
    """SRP -> coarse -> fine -> NMS with DelayAndSumExecutor(mesh=...): the
    unsharded run's clusters, and its head audio at rtol 1e-4 / atol 1e-5."""
    got = _same_on_all_ranks(two_ranks["out"], 1)
    want = two_ranks["stack"]
    assert len(got["heads"]) == len(want["heads"]) >= 1
    for g, w in zip(got["heads"], want["heads"]):
        np.testing.assert_allclose(g["center"], w["center"])
        np.testing.assert_allclose(g["localization_offset"],
                                   w["localization_offset"])
        np.testing.assert_array_equal(g["audio_offset"], w["audio_offset"])
        assert g["label"] == w["label"]
    assert len(got["audio"]) == len(want["audio"])
    for g, w in zip(got["audio"], want["audio"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# --- case 5: the data-parallel train step ------------------------------------

def _single_step(params, batch, step, perturb):
    model = SpotNet(**STEP_SPOT)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in _flat(params["params"]).items()})
    _, train_step, _ = make_step_fns(model, "SpeakerLocalization", "fused",
                                     STEP_CLIP, STEP_LR, perturb=perturb)
    loss = float(train_step(tuple(torch.from_numpy(x) for x in batch), step))
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    new = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return loss, grads, new


def _assert_adam_step_close(got, want, grads, scale_tol):
    """Adam's first step moves a coordinate by about lr * sign(g), so where
    |g| is near its eps any value in (-lr, lr) is right: the parameters
    must agree within `scale_tol` of each tensor's scale where |g| > 1e-6,
    and within 2 * lr everywhere."""
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * STEP_LR, k
        big = np.abs(grads[k]) > 1e-6
        tol = scale_tol * max(np.abs(w).max(), 1e-30)
        assert (diff[big] <= tol).all(), (k, diff[big].max(), tol)


@pytest.mark.parametrize("noise", [False, True])
def test_sharded_train_step_matches_single_process(noise, two_ranks):
    """2 ranks against make_step_fns' step on the whole batch: the loss at
    rtol 1e-5, and the parameters after the step within 1e-6 of each
    tensor's scale (where the gradient is not vanishing, see
    _assert_adam_step_close).  With the noise on, both draw it for the
    whole batch from the generator of (seed 0, step 3)."""
    params, batch = two_ranks["step"]
    got = _same_on_all_ranks(two_ranks["out"], 3 if noise else 2)
    loss, grads, new = _single_step(params, batch, 3 if noise else None,
                                    PERTURB if noise else None)
    assert np.isfinite(loss) and abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    _assert_adam_step_close(got["params"], new, grads, 1e-6)


def test_sharded_train_step_matches_jax(two_ranks):
    """2 ranks against JAX shard_train_step on a 2-device mesh, noise off:
    the tolerances of test_torch_training.py::test_one_train_step_matches_jax
    (the loss at rel 1e-5; the parameters within 1e-3 * lr where |g| >
    1e-6, and within 2 * lr everywhere)."""
    params, batch = two_ranks["step"]
    got = _same_on_all_ranks(two_ranks["out"], 2)
    j_opt, j_step, _ = jax_make_step_fns(JaxSpotNet(**STEP_SPOT),
                                         "SpeakerLocalization", "fused",
                                         STEP_CLIP)
    opt_state = j_opt.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(STEP_LR)
    mesh = jax_mesh.make_mesh(n_data=1, n_cand=2, devices=jax.devices()[:2])
    with mesh:
        j_params, opt_state, j_loss = jax_mesh.shard_train_step(mesh, j_step)(
            params, opt_state, tuple(jnp.asarray(b) for b in batch))
    j_loss = float(j_loss)
    assert np.isfinite(j_loss)
    assert abs(got["loss"] - j_loss) <= 1e-5 * abs(j_loss), (got["loss"], j_loss)
    grads = {k: v / 0.1 for k, v in
             _flat(opt_state.inner_state[0].mu["params"]).items()}
    for k, w in _flat(j_params["params"]).items():
        diff = np.abs(got["params"][k] - w)
        assert diff.max() <= 2 * STEP_LR, k
        big = np.abs(grads[k]) > 1e-6
        assert (diff[big] <= 1e-3 * STEP_LR).all(), (k, diff[big].max())


# --- case 6: failures ----------------------------------------------------------

def _cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "acousticswarms_speech_tpu_torch.parallel.dryrun",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_dryrun_cli_four_cpu_ranks():
    """The dry run (train step, sharded sweep, grid-sharded SRP) on a 2 x 2
    mesh of gloo ranks exits 0."""
    proc = _cli("--n_devices", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun(4, cpu, gloo): mesh [2, 2]" in proc.stdout


def test_dryrun_cli_exits_1_when_launch_fails():
    """nccl on the CPU is refused: the CLI prints why and exits 1."""
    proc = _cli("--n_devices", "2", "--device", "cpu", "--backend", "nccl")
    assert proc.returncode == 1
    assert "nccl backend needs device='cuda'" in proc.stderr


def test_failing_rank_makes_launch_raise():
    """Rank 1 fails to load its network while rank 0 waits in the sweep's
    first collective: launch raises rank 1's error and kills rank 0, long
    before the process group's timeout."""
    model, _, mix, cands = _exec_case()
    spec = _spec(EXEC_SPOT, model)
    bad = {"exp_dir": os.path.join(REPO, "no_such_experiment")}
    args = [(spec, mix, cands), (bad, mix, cands)]
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        launch(ranks.per_rank, 2, "gloo", "cpu",
               args=(ranks.sweep, args), timeout_s=600, deadline_s=120)
    assert "no_such_experiment" in str(err.value)


def test_diverged_candidate_lists_raise():
    """Ranks given different candidate lists raise the divergence error on
    every rank instead of pairing mismatched collectives."""
    _, _, mix, cands = _exec_case()
    args = [(None, mix, cands), (None, mix, cands[:-1] + [cands[0]])]
    with pytest.raises(RuntimeError, match="disagree on the sweep's candidates"):
        launch(ranks.per_rank, 2, "gloo", "cpu", args=(ranks.sweep, args),
               deadline_s=120)


def test_nccl_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(ranks.sequence, 1, "nccl", "cuda", args=([],))


def test_lanes_refuse_a_multi_rank_mesh():
    """Two lanes would issue the sweeps' collectives from two threads."""
    pipe = types.SimpleNamespace(mesh=types.SimpleNamespace(size=2))
    with pytest.raises(ValueError, match="use one lane"):
        PipelinedRunner(pipe, n_lanes=2)
    assert PipelinedRunner(pipe, n_lanes=1).lanes == [pipe]


def test_device_follows_the_mesh():
    mesh = types.SimpleNamespace(device=torch.device("cpu"))
    assert resolve_device(None, mesh) == torch.device("cpu")
    assert resolve_device("cpu", mesh) == torch.device("cpu")
    with pytest.raises(ValueError, match="differs from the mesh"):
        resolve_device("cuda", mesh)
