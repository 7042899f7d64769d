"""Multi-process parallelism for the swarm pipeline (JAX: parallel/mesh.py).

The workload's scaling axes are the JAX package's:
- `data`: independent mixtures, or the batch of a train step;
- `cand`: spotforming candidates and SRP grid points, the workload's own
  scaling axis.

The JAX package shards jitted programs over a device mesh.  The port runs
one process per rank (`launch`), lays the ranks out row-major over
("data", "cand") (`Mesh`), and joins the split work with explicit
collectives:
- the candidate-sharded sweep (search/spotform.py with `mesh=`): each
  `cand` rank rolls and runs its slice of the candidates, then the slices
  are all-gathered;
- `shard_srp_map`: each `cand` rank steers its slice of the grid, and the
  map is all-gathered;
- `srp_time_sharded`: each `cand` rank maps its own slab of analysis
  windows, merged by a MAX all-reduce (the JAX package's `pmax`);
- `shard_train_step`: the batch is split over the whole world and the
  gradients are summed before the clip and the Adam step.

The models stay replicated, as in the JAX package.  Host code (SRP peak
picking, subdivision, NMS) runs identically on every rank, so every rank
returns the same result.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.srp import srp_phat_map


class Mesh:
    """The world's ranks laid out row-major over ("data", "cand").

    `cand_group` is the process group of this rank's `cand` row; the whole
    world (the default group) is the `data` x `cand` group that the train
    step reduces over.  `device` is this rank's device."""

    def __init__(self, n_data: int, n_cand: int, device: torch.device):
        world = dist.get_world_size()
        if n_data * n_cand != world:
            raise ValueError(f"mesh {n_data} x {n_cand} does not match the "
                             f"world size {world}")
        self.backend = dist.get_backend()
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError(f"the nccl backend needs CUDA devices, got {device}")
        self.shape = {"data": n_data, "cand": n_cand}
        self.size = world
        self.rank = dist.get_rank()
        self.data_index, self.cand_index = divmod(self.rank, n_cand)
        self.device = device
        # dist.new_group must be entered by every rank for every group, in
        # the same order
        rows = [dist.new_group(list(range(d * n_cand, (d + 1) * n_cand)))
                for d in range(n_data)]
        self.cand_group = rows[self.data_index]

    def all_gather_cand(self, x: torch.Tensor) -> torch.Tensor:
        """The `cand` row's equal-sized slices of a tensor, concatenated
        along dim 0 in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape["cand"])]
        dist.all_gather(parts, x, group=self.cand_group)
        return torch.cat(parts)

    def max_cand(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the `cand` row (the JAX package's pmax)."""
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.cand_group)
        return x

    def check_same_cand(self, values, what: str) -> None:
        """Raise on every rank of the `cand` row unless all of them pass the
        same integers.  Ranks that disagree on a sweep's inputs would pair
        mismatched collectives, and hang or mix results."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self.device)
        both = torch.cat([t, -t])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.cand_group)
        hi, neg_lo = both.cpu().split(len(t))
        if not torch.equal(hi, -neg_lo):
            raise RuntimeError(
                f"the ranks of cand row {self.data_index} disagree on {what}: "
                f"this rank has {t.tolist()}, the row's max is {hi.tolist()} "
                f"and its min {(-neg_lo).tolist()}")


def make_mesh(n_data: int = 1, n_cand: int | None = None,
              device=None) -> Mesh:
    """The mesh over the current process group (JAX: make_mesh).  `n_cand`
    defaults to world size // n_data; `device` is this rank's device
    (default cuda, the current one)."""
    world = dist.get_world_size()
    if n_cand is None:
        n_cand = world // n_data
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(n_data, n_cand, device)


def shard_srp_map(mesh: Mesh, srp_fn):
    """Grid parallelism over the SRP steering product (JAX: shard_srp_map).

    `srp_fn(signal, steer_re, steer_im, bins)` -> (G,) map, e.g.
    ops.srp.srp_phat_map with window, nfft and hop bound.  Returns a
    function of the same arguments in which each `cand` rank steers its
    ceil(G / n) rows of the tables (the last ranks' slices are padded with
    zeros) and the (G,) map is all-gathered."""
    n = mesh.shape["cand"]

    def sharded(signal, steer_re, steer_im, bins):
        G = steer_re.shape[0]
        local = -(-G // n)
        rows = slice(mesh.cand_index * local, (mesh.cand_index + 1) * local)
        part = srp_fn(signal, steer_re[rows], steer_im[rows], bins)
        part = torch.cat([part, part.new_zeros(local - part.shape[0])])
        return mesh.all_gather_cand(part)[:G]

    return sharded


def srp_time_sharded(mesh: Mesh):
    """Sequence-parallel SRP (JAX: srp_time_sharded): each `cand` rank maps
    its own range of analysis windows, and the per-grid maxima merge with a
    MAX all-reduce, the collective form of the reference's running max over
    windows.

    Returns build(window, nfft, hop) -> fn(slabs, steer_re, steer_im, bins)
    -> (G,) map, where `slabs` is (D, M, Tw) with one slab per `cand` rank."""

    def build(window: int, nfft: int, hop: int):
        def fn(slabs, steer_re, steer_im, bins):
            if slabs.shape[0] != mesh.shape["cand"]:
                raise ValueError(f"{slabs.shape[0]} slabs for "
                                 f"{mesh.shape['cand']} cand ranks")
            part = srp_phat_map(slabs[mesh.cand_index], steer_re, steer_im,
                                bins, window, nfft, hop)
            return mesh.max_cand(part)

        return fn

    return build


def _flat_collective(tensors: list[torch.Tensor], collective) -> None:
    """`collective` on one flat copy of `tensors` (one call for all of
    them), written back in place."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def shard_train_step(mesh: Mesh, model: torch.nn.Module, model_name: str,
                     loss_name: str, gradient_clip: float, lr: float,
                     perturb: tuple | None = None, base_seed: int = 0):
    """Data-parallel training step (JAX: shard_train_step): the batch is
    split over the whole `data` x `cand` world; parameters and Adam state
    are replicated (rank 0's parameters are broadcast here).

    Returns (optimizer, train_step).  `train_step(batch, step=None)` takes
    the global batch on every rank and returns the global batch's loss.
    It draws the noise augmentation for the global batch, as the
    single-process step does, and keeps its own rows.  Each rank's loss is
    its share of the global loss: the masked means of the losses divide by
    the global batch's counts.  So the gradients summed over the world are
    the global batch's gradients, as with the JAX package's psum, whatever
    each shard's mix of silent and voiced targets.  The sum comes before
    the global-norm clip and the Adam step."""
    from ..training.losses import get_loss_fn
    from ..training.train import (_device_perturb, clip_by_global_norm_,
                                  compute_loss, perturb_generator)

    loss_fn = get_loss_fn(loss_name)
    params = [p for p in model.parameters() if p.requires_grad]
    with torch.no_grad():
        _flat_collective([p.data for p in params],
                         lambda flat: dist.broadcast(flat, src=0))
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    world, rank = mesh.size, mesh.rank

    def train_step(batch, step=None) -> torch.Tensor:
        B = batch[0].shape[0]
        if B % world:
            raise ValueError(f"batch of {B} does not split over {world} ranks")
        model.train()
        if step is not None:
            gen = perturb_generator(base_seed, step, batch[0].device)
            batch = (_device_perturb(gen, batch[0], *perturb),) + tuple(batch[1:])
        rows = slice(rank * (B // world), (rank + 1) * (B // world))
        optimizer.zero_grad(set_to_none=True)
        share = compute_loss(model, model_name, loss_fn,
                             tuple(x[rows] for x in batch), count_gt=batch[1])
        share.backward()
        grads = [p.grad for p in params]
        with torch.no_grad():
            _flat_collective(grads, lambda flat: dist.all_reduce(flat))
        clip_by_global_norm_(grads, gradient_clip)
        optimizer.step()
        loss = share.detach().clone()
        dist.all_reduce(loss)
        return loss

    return optimizer, train_step


# --- launcher ---------------------------------------------------------------

def _rank_device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, world_size, backend, device, store_path, timeout_s, fn,
               args, results) -> None:
    """One rank: join the process group, run fn(rank_device, *args) and put
    (rank, True, value) or (rank, False, traceback) on `results`."""
    try:
        # All ranks live on this host: rendezvous over the loopback.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
            device_id=dev if backend == "nccl" else None)
        value = fn(dev, *args)
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 (reported to the parent, exit 1)
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        sys.exit(1)
    results.put((rank, True, value))


def launch(fn, world_size: int, backend: str = "nccl", device: str = "cuda",
           args: tuple = (), timeout_s: float = 300.0,
           deadline_s: float = 900.0) -> list:
    """Run `fn(rank_device, *args)` on `world_size` ranks and return their
    values in rank order.

    Ranks are processes of the spawn start method (fork is unsafe once
    CUDA is initialised), so `fn` must be a module-level function that
    imports no JAX, and `args` and the values must pickle.  They join one
    process group of `backend` through a FileStore in a temporary
    directory, with `timeout_s` on every collective.  A rank's device is
    cuda:(rank % device count), or the CPU for `device="cpu"`.

    Raises when a rank raises or exits without a value (with its
    traceback), or when the ranks are not done within `deadline_s`; the
    other ranks are killed then.  Nothing falls back: nccl needs one card
    per rank, and `device="cuda"` needs a card."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(with backend='gloo') to run the ranks on the CPU")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"nccl cannot run {world_size} ranks on "
                f"{torch.cuda.device_count()} GPU(s): it needs one GPU per "
                f"rank; use backend='gloo' to share a GPU between ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, backend, device, store,
                                   timeout_s, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            values = _collect(procs, results, deadline_s)
            for p in procs:
                p.join(timeout=60)
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return values


def _collect(procs, results, deadline_s: float) -> list:
    """The ranks' values in rank order; raises at the first failure."""
    deadline = time.monotonic() + deadline_s
    got: dict[int, object] = {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = [r for r in range(len(procs)) if r not in got]
            raise TimeoutError(f"ranks {missing} not done within "
                               f"{deadline_s:.0f} s")
        try:
            rank, ok, value = results.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None}
            if dead:
                raise RuntimeError(f"ranks exited without a result "
                                   f"(rank: exit code) {dead}") from None
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{value}")
        got[rank] = value
    return [got[r] for r in range(len(procs))]
