"""Rank programs: the module-level targets that parallel.mesh.launch runs.

Each takes the rank's device first, builds a one-row mesh over the
launched world (every rank on the `cand` axis), runs one sharded
operation of the port, and returns host values (numpy arrays, floats,
dicts) that pickle back to the launching process.  The
dry run (parallel/dryrun.py), chip_smoke.py and the tests run them.  They
live in the package, not beside their callers, because a spawned rank
imports its target's module, and this one imports no JAX.

A network is given as a spec, so that each rank builds its own copy
instead of receiving a pickled module: None (the delay-and-sum
spotformer), {"exp_dir": d} (the release weights of an experiment
directory), or {"model_name", "model_params", "state"} (a description's
model with a state_dict of numpy arrays).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .mesh import make_mesh, shard_srp_map, shard_train_step, srp_time_sharded


def build_net(spec, device) -> torch.nn.Module | None:
    if spec is None:
        return None
    if "exp_dir" in spec:
        from ..models.weights import load_release

        return load_release(spec["exp_dir"], device)
    from ..models.weights import create_model

    model = create_model(spec["model_name"], spec["model_params"])
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in spec["state"].items()})
    return model.to(device)


def _mesh(device):
    """One `cand` row over the whole world."""
    return make_mesh(1, dist.get_world_size(), device)


def _executor(spec, device, mesh=None):
    from ..search.spotform import DelayAndSumExecutor, SpotformExecutor

    net = build_net(spec, device)
    if net is None:
        return DelayAndSumExecutor(device=device, mesh=mesh)
    return SpotformExecutor(net, device=device, mesh=mesh)


def sequence(device, calls) -> list:
    """Several programs in one launch: [fn(device, *args) for fn, args in
    calls]."""
    return [fn(device, *args) for fn, args in calls]


def per_rank(device, fn, args_by_rank):
    """fn(device, *args_by_rank[rank]): each rank with its own arguments."""
    return fn(device, *args_by_rank[dist.get_rank()])


def srp_grid(device, signal, steer_re, steer_im, bins, window, nfft,
             hop) -> np.ndarray:
    """The grid-sharded SRP map (mesh.shard_srp_map) of `signal`."""
    from ..ops.srp import srp_phat_map

    mesh = _mesh(device)
    fn = shard_srp_map(mesh, lambda s, re, im, b: srp_phat_map(
        s, re, im, b, window, nfft, hop))
    t = [torch.as_tensor(x, device=mesh.device)
         for x in (signal, steer_re, steer_im, bins)]
    return fn(*t).cpu().numpy()


def srp_time(device, slabs, steer_re, steer_im, bins, window, nfft,
             hop) -> np.ndarray:
    """The time-sharded SRP map (mesh.srp_time_sharded): rank r maps slab
    r of the (D, M, Tw) `slabs`."""
    mesh = _mesh(device)
    fn = srp_time_sharded(mesh)(window, nfft, hop)
    t = [torch.as_tensor(x, device=mesh.device)
         for x in (slabs, steer_re, steer_im, bins)]
    return fn(*t).cpu().numpy()


def _sweep_values(res) -> dict:
    rows = res.gather(range(res.n), quantize=False)
    return {"powers": res.powers, "powers_win": res.powers_win,
            "sisdr_mat": res.sisdr_mat,
            "waveforms": np.stack([rows[i] for i in range(res.n)])}


def sweep(device, net, mix, patch_list, strict: int = 0,
          with_similarity: bool = False) -> dict:
    """One candidate-sharded sweep; powers, windowed powers, the SI-SDR
    matrix (or None) and the (K, T) waveforms."""
    executor = _executor(net, device, _mesh(device))
    return _sweep_values(executor.sweep(mix, patch_list, strict=strict,
                                        with_similarity=with_similarity))


def search_stack(device, mix, mic_pos, roi, grid_size: float,
                 cache_dir: str | None = None) -> dict:
    """SRP -> coarse -> fine -> NMS (MicArray's stages, what
    JointPipeline.forward runs) with a candidate-sharded delay-and-sum
    executor; the head audio and each head's center, localization and
    audio offsets."""
    from ..pipeline.mic_array import MicArray

    executor = _executor(None, device, _mesh(device))
    arr = MicArray(mic_pos, spk_range=roi, grid_size=grid_size,
                   cache_dir=cache_dir, device=device)
    patches, _ = arr.apply_srp_phat(mix)
    big = arr.spotform_big_patch(mix, patches, executor)
    pairs = arr.spotform_small_patch_parallel(mix, big, executor)
    audio, heads, _, _ = arr.clustering_new(pairs)
    return {"audio": [np.asarray(a) for a in audio],
            "heads": [head_summary(h) for h in heads]}


def head_summary(head) -> dict:
    """What identifies a final head of the search: its center, its
    localization and audio offsets, and its label."""
    return {"center": np.asarray(head[0].center_pos(), dtype=np.float64),
            "localization_offset":
                np.asarray(head[4]["localization_offset"], dtype=np.float64),
            "audio_offset": np.asarray(head[4]["audio_offset"]),
            "label": head[3]}


def train_step(device, net, loss_name: str, batch, step, perturb,
               gradient_clip: float, lr: float) -> dict:
    """One data-parallel train step (mesh.shard_train_step) of `net` on the
    global `batch`; the loss and the updated parameters."""
    model = build_net(net, device)
    _, step_fn = shard_train_step(_mesh(device), model,
                                  net["model_name"], loss_name, gradient_clip,
                                  lr, perturb)
    batch = tuple(torch.as_tensor(x, device=device) for x in batch)
    loss = step_fn(batch, step)
    return {"loss": float(loss),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()}}


# --- the release networks on the card (chip_smoke.py's mesh phase) ----------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_gathers(mesh, device, seconds: list) -> None:
    """Add the wall time of each of the mesh's all-gathers (with the wait
    for the row's slowest rank) to seconds[0]."""
    real = mesh.all_gather_cand

    def timed(x):
        _sync(device)
        t0 = time.perf_counter()
        out = real(x)
        _sync(device)
        seconds[0] += time.perf_counter() - t0
        return out

    mesh.all_gather_cand = timed


def release_mesh_check(device, spot_dir, mix_sweep, offsets,
                       deterministic: bool, forward=None) -> dict:
    """The release localization network on a one-row mesh over the launched
    world, in float32 with TF32 off: rank 0 sweeps `offsets` on `mix_sweep`
    unsharded, then every rank sweeps them sharded.  With `forward` = {"sep_dir",
    "mix", "mic_pos", "roi", "cache_dir"}, rank 0 also runs the unsharded
    JointPipeline.forward of `mix`, and every rank then the sharded one
    (after one warm-up forward).

    The roll kernel's and K5's launch counts are set to 0 just before the
    sharded sweep and forward and read just after; the roll kernel's inputs
    there are recorded, and the kernel is then held against its plain
    version on the largest.
    Rank 0 returns the comparisons; every rank its times, launches, spot
    calls, peak memory and a checksum of its results."""
    import zlib

    from ..ops import shift as shift_ops
    from ..ops.residual_epilogue import residual_epilogue_cuda
    from ..ops.roll_kernel import roll_channels_batch_cuda
    from ..pipeline.joint import JointPipeline
    from ..search import spotform

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.reset_peak_memory_stats(device)
    mesh = _mesh(device)
    rank = mesh.rank
    spot = build_net({"exp_dir": spot_dir}, device)
    mix_sweep = torch.as_tensor(mix_sweep, device=device)
    out = {"rank": rank, "backend": mesh.backend, "device": str(device),
           "world": mesh.size}

    def timed(fn):
        _sync(device)
        t0 = time.perf_counter()
        r = fn()
        _sync(device)
        return r, time.perf_counter() - t0

    def pipeline(**kwargs):
        pipe = JointPipeline(spot, sep, **kwargs)
        pipe.setup(forward["mic_pos"], forward["roi"],
                   cache_dir=forward["cache_dir"])
        return pipe

    def run_forward(pipe):
        (patches, _, audio, *_), sec = timed(lambda: pipe.forward(
            forward["mix"]))
        return {"heads": [head_summary(p) for p in patches],
                "audio": np.asarray(audio)}, sec

    plain_exec = spotform.SpotformExecutor(spot, device=device)
    sharded_exec = spotform.SweepLane(
        spotform.SpotformExecutor(spot, device=device, mesh=mesh))
    gather_s = [0.0]
    _timed_gathers(mesh, device, gather_s)
    sweep_args = (mix_sweep, offsets)
    sweep_kw = {"strict": 1, "with_similarity": True}
    # warm-ups: the first sweep and forward of a process set up cuDNN
    sharded_exec.sweep(mix_sweep, offsets[:8], **sweep_kw).powers
    plain = None
    if rank == 0:
        plain_exec.sweep(mix_sweep, offsets[:8], **sweep_kw).powers
        plain, out["unsharded_sweep_s"] = timed(
            lambda: plain_exec.sweep(*sweep_args, **sweep_kw))
    if forward is not None:
        sep = build_net({"exp_dir": forward["sep_dir"]}, device)
        sharded_pipe = pipeline(mesh=mesh)
        sharded_pipe.forward(forward["mix"])
        if rank == 0:
            out["unsharded_forward"], out["unsharded_forward_s"] = \
                run_forward(pipeline(device=device))
    dist.barrier()
    sharded_exec.calls = 0
    gather_s[0] = 0.0

    rolls = []
    real_roll = shift_ops.roll_channels_batch

    def recording_roll(m, s):
        rolls.append((m.clone(), s.clone()))
        return real_roll(m, s)

    spotform.roll_channels_batch = recording_roll
    roll_channels_batch_cuda.launches = residual_epilogue_cuda.launches = 0
    try:
        sharded, out["sharded_sweep_s"] = timed(
            lambda: sharded_exec.sweep(*sweep_args, **sweep_kw))
        out["gather_s"] = gather_s[0]
        out["sweep_launches"] = roll_channels_batch_cuda.launches
        out["sweep_spot_calls"] = sharded_exec.calls
        if forward is not None:
            sharded_pipe.spot_model.calls = 0
            out["sharded_forward"], out["sharded_forward_s"] = \
                run_forward(sharded_pipe)
            out["forward_spot_calls"] = sharded_pipe.spot_model.calls
        out["launches"] = roll_channels_batch_cuda.launches
        out["k5_launches"] = residual_epilogue_cuda.launches
    finally:
        spotform.roll_channels_batch = real_roll
    values = _sweep_values(sharded)
    out["checksum"] = zlib.crc32(b"".join(
        np.ascontiguousarray(values[k]).tobytes()
        for k in ("powers", "powers_win", "sisdr_mat", "waveforms")))
    if plain is not None:
        want = _sweep_values(plain)
        peak = float(np.abs(want["waveforms"]).max())
        out["sweep"] = {
            "K": len(offsets), "T": int(mix_sweep.shape[1]),
            "powers": (values["powers"], want["powers"]),
            "powers_win": (values["powers_win"], want["powers_win"]),
            "sisdr_max_abs_diff": float(np.abs(values["sisdr_mat"]
                                               - want["sisdr_mat"]).max()),
            "waveform_max_abs_diff": float(np.abs(values["waveforms"]
                                                  - want["waveforms"]).max()),
            "waveform_peak": peak}
    out["kernel"] = _check_largest_roll(rolls)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def _check_largest_roll(rolls) -> dict:
    """The roll kernel against its plain version on the largest recorded
    launch (exact: the kernel copies)."""
    from ..ops.roll_kernel import roll_channels_batch_cuda
    from ..ops.shift import roll_channels_batch_plain

    mix, shifts = max(rolls, key=lambda r: r[1].shape[0] * r[0].shape[1])
    got = roll_channels_batch_cuda(mix, shifts)
    want = roll_channels_batch_plain(mix, shifts)
    return {"shape": [shifts.shape[0], mix.shape[0], mix.shape[1]],
            "max_abs_err": float((got - want).abs().max()),
            "equal": bool(torch.equal(got, want))}
