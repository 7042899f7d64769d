"""Training entry point: experiment-dir driven, resumable, plateau-scheduled
(JAX: training/train.py).

    python -m acousticswarms_speech_tpu_torch.training.train <experiment_dir>
        [--max_steps_per_epoch N] [--device cuda|cpu]

Counterpart of reference sep/training/train.py and the per-model
train_epoch/test_epoch loops:
- description.json selects the model, loss, lr schedule and dataset params;
- one train step: (noise augmentation on the device) -> normalize ->
  forward -> unnormalize -> loss -> backward -> global-norm clip as optax
  does it -> Adam with optax's defaults;
- per-epoch param checkpoints in the JAX package's layout, auto-resume from
  the latest epoch, warm start from `pretrain_path`;
- ReduceLROnPlateau on the validation loss;
- deterministic seeding: per-epoch reseed for training, fixed VAL_SEED for
  validation.

The JAX package's mechanisms for its TPU relay (int16 batch transfers,
device prefetch, the compilation cache, the restart on host-memory growth)
are not ported: batches are copied from pinned host memory without
blocking.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import normalize_input, unnormalize_input
from ..models.convert import load_converted, load_torch_checkpoint
from ..models.factory import create_model, init_model, param_count
from ..utils.misc import seed_all
from ..utils.pink_noise import powerlaw_psd_gaussian_torch
from . import checkpoints as ckpt
from .datasets import BatchLoader, LocalizationDataset, SeparationDataset
from .experiment import load_model_from_exp, read_description
from .losses import get_loss_fn, neg_sdr
from .schedulers import ReduceLROnPlateau

VAL_SEED = 0

DATASET_REGISTRY = {
    "SpeakerLocalization": LocalizationDataset,
    "SpeakerSeparation": SeparationDataset,
}


def perturb_generator(seed: int, step: int, device) -> torch.Generator:
    """The noise generator of one train step, on `device`, seeded from
    (seed, step)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _device_perturb(generator: torch.Generator, data: torch.Tensor,
                    max_white_var: float, max_pink_var: float) -> torch.Tensor:
    """BaseDataset.perturb_audio on the device: per-item scalar noise
    levels, unit-variance pink + white noise added to the (B, C, T) input
    stack, drawn from `generator`."""
    levels = torch.rand((2, data.shape[0]) + (1,) * (data.dim() - 1),
                        generator=generator, device=data.device)
    pink = powerlaw_psd_gaussian_torch(1, data.shape, generator,
                                       device=data.device)
    white = torch.randn(data.shape, generator=generator, device=data.device)
    return (data + levels[0] * max_pink_var * pink
            + levels[1] * max_white_var * white)


def compute_loss(model: torch.nn.Module, model_name: str, loss_fn,
                 batch, count_gt: torch.Tensor | None = None) -> torch.Tensor:
    """The loss of `batch`; with `count_gt` (the targets of a whole batch
    of which `batch` holds some rows), this batch's share of that batch's
    loss (training/losses.py)."""
    data, gt, cond = batch  # cond: window embedding or speaker counts
    normed, means, stds = normalize_input(data)
    out = unnormalize_input(model(normed, cond), means, stds)
    if model_name == "SpeakerLocalization":
        return loss_fn(out, gt, count_gt=count_gt)
    B, S, T = out.shape
    if count_gt is not None:
        count_gt = count_gt.reshape(-1, 1, T)
    return loss_fn(out.reshape(B * S, 1, T), gt.reshape(B * S, 1, T),
                   count_gt=count_gt)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: gradients stay as they are when
    their global norm is below `max_norm`, else they are scaled by
    max_norm / norm (`clip_grad_norm_` would add 1e-6 to the norm).
    Returns the norm before clipping."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def make_step_fns(model: torch.nn.Module, model_name: str, loss_name: str,
                  gradient_clip: float, lr: float,
                  perturb: tuple | None = None, base_seed: int = 0):
    """(optimizer, train_step, eval_step) for `model`.

    `train_step(batch, step=None)` runs one update and returns the loss (a
    0-dim tensor on the device, not synchronized); the clipped gradients
    stay in the parameters' `.grad`.  With `perturb = (max_white_var,
    max_pink_var)` it adds the noise augmentation on the device, from the
    generator of (`base_seed`, `step`)."""
    loss_fn = get_loss_fn(loss_name)
    params = [p for p in model.parameters() if p.requires_grad]
    # optax.adam's defaults
    optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def train_step(batch, step=None) -> torch.Tensor:
        model.train()
        if step is not None:
            gen = perturb_generator(base_seed, step, batch[0].device)
            batch = (_device_perturb(gen, batch[0], *perturb),) + tuple(batch[1:])
        optimizer.zero_grad(set_to_none=True)
        loss = compute_loss(model, model_name, loss_fn, batch)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], gradient_clip)
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(batch) -> torch.Tensor:
        model.eval()
        return compute_loss(model, model_name, loss_fn, batch)

    return optimizer, train_step, eval_step


def to_device(batch, device: torch.device) -> tuple:
    """A host batch of numpy arrays -> tensors on `device` (float32 data,
    int64 speaker counts), copied from pinned memory without blocking."""
    out = []
    for x in batch:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.is_floating_point():
            t = t.float()
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


@torch.no_grad()
def _sisdr_metrics(model, model_name, batch, device) -> list[dict]:
    """Validation SI-SDR metrics on positive samples (reference
    SpeakerLocalization/train.py:15-46)."""
    model.eval()
    data, gt, cond = batch
    x = to_device(batch, device)
    normed, means, stds = normalize_input(x[0])
    out = unnormalize_input(model(normed, x[2]), means, stds)
    if model_name == "SpeakerLocalization":
        est, ref, orig = out[:, 0], x[1][:, 0], x[0][:, 0]
    else:
        B, S, T = out.shape
        est = out.reshape(B * S, T)
        ref = x[1].reshape(B * S, T)
        orig = x[0][:, 0:1].expand(B, S, T).reshape(B * S, T)
    idx = torch.nonzero(ref.abs().amax(dim=1) > 0).flatten()
    if idx.numel() == 0:
        return []
    in_sisdr = -neg_sdr(orig[idx], ref[idx], "sisdr")
    out_sisdr = -neg_sdr(est[idx], ref[idx], "sisdr")
    return [{"input_si_sdr": float(a), "si_sdr": float(b)}
            for a, b in zip(in_sisdr.tolist(), out_sisdr.tolist())]


def train(experiment_dir: str, seed: int = 0, print_interval: int = 20,
          max_steps_per_epoch: int | None = None,
          compute_val_metrics: bool = False, device=None, on_step=None):
    """Train the experiment's network; returns (train_losses, val_losses).

    `device` defaults to cuda.  `on_step(model, info)`, when given, is
    called after every train step with info {"epoch", "step", "loss",
    "seconds"}; it synchronizes the device each step to read the loss."""
    device = resolve_device(device)
    seed_all(seed)
    desc = read_description(experiment_dir)
    model_name = desc["model_name"]
    model_params = desc["model_params"]
    training_params = desc["training_params"]
    lr_sched_params = desc["lr_sched_params"]
    sr = desc["sr"]

    train_set_params = dict(desc["train_set_params"], sr=sr)
    test_set_params = dict(desc["test_set_params"], sr=sr)

    experiment_name = os.path.basename(experiment_dir.rstrip("/"))
    checkpoints_dir = os.path.join(experiment_dir, "checkpoints")
    os.makedirs(checkpoints_dir, exist_ok=True)

    ds_cls = DATASET_REGISTRY[model_name]
    data_train = ds_cls(dataset_type="train", **train_set_params)
    data_test = ds_cls(dataset_type="test", **test_set_params)
    train_loader = BatchLoader(data_train, training_params["batch_size"],
                               shuffle=True, seed=seed)
    test_loader = BatchLoader(data_test, training_params["batch_size"])

    model = init_model(create_model(model_name, model_params), seed=seed)
    print(f"Model has {param_count(model) / 1e6:.02f}M parameters.")

    # Noise augmentation on the device, with the host perturb_audio's
    # distribution; only when the codec augmentation is off, since the
    # reference's order is perturb-then-codec.
    perturb = None
    if (os.environ.get("ACOUSTIC_DEVICE_PERTURB", "1") != "0"
            and float(train_set_params.get("compression_prob", 0.7)) == 0):
        perturb = (float(data_train.max_white_noise_variance),
                   float(data_train.max_pink_noise_variance))
        data_train.perturb_on_device = True
        print("Device-side perturb: on "
              f"(white {perturb[0]:g}, pink {perturb[1]:g})")

    # Resume / warm start (reference train.py:117-137)
    latest = ckpt.latest_checkpoint(checkpoints_dir, experiment_name)
    start_epoch = 0
    if latest is not None:
        start_epoch = latest[0] + 1
        model.load_state_dict(ckpt.load_params(latest[1]), strict=True)
        print(f"Resumed from epoch {latest[0]}")
    elif "pretrain_path" in training_params:
        pre = training_params["pretrain_path"]
        if pre.endswith(".pt"):
            # a reference torch checkpoint; a key the converter cannot place
            # raises
            load_converted(model, load_torch_checkpoint(pre), model_name,
                           source=pre)
        elif os.path.isdir(pre):
            # an experiment directory: warm start from its best checkpoint
            # (or its release weights)
            model.load_state_dict(load_model_from_exp(
                pre, mode="best", device="cpu").state_dict(), strict=True)
        else:
            model.load_state_dict(ckpt.load_params(pre), strict=True)
        print(f"Warm start from {pre}")
    model.to(device)

    lr = training_params["lr"]
    optimizer, train_step, eval_step = make_step_fns(
        model, model_name, training_params["loss"],
        training_params["gradient_clip"], lr, perturb=perturb, base_seed=seed)

    scheduler = ReduceLROnPlateau(
        lr_min=lr_sched_params["lr_min"], factor=lr_sched_params["factor"],
        patience=lr_sched_params["patience"],
        dont_halve_until_epoch=lr_sched_params["dont_halve_until_epoch"],
    )
    train_losses: list[float] = []
    val_losses: list[float] = []
    val_epochs: list[int] = []

    state_path = os.path.join(checkpoints_dir, "state.msgpack")
    if latest is not None:
        try:
            saved = ckpt.load_optimizer_state(state_path, device)
        except (OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            # Corrupt or interrupted state: params resume from the epoch
            # checkpoint and the optimizer restarts fresh.
            print(f"[WARNING] could not load optimizer state ({e}); "
                  "resuming with a fresh optimizer")
            saved = None
        if saved is not None:
            optimizer.load_state_dict(saved["optimizer"])
            lr = float(saved["lr"])
        # The sidecar is written every epoch and the optimizer state only
        # every SWARM_OPT_STATE_EVERY epochs, so the sidecar is the fresher
        # record of the histories, the lr and the scheduler.
        summary = ckpt.load_state_summary(state_path)
        if summary:
            train_losses = list(summary["train_losses"])
            val_losses = list(summary["val_losses"])
            val_epochs = ckpt.summary_val_epochs(summary)
            lr = float(summary.get("lr", lr))
            if "scheduler" in summary:
                scheduler.load_state_dict(summary["scheduler"])
        for group in optimizer.param_groups:
            group["lr"] = lr

    for epoch in range(start_epoch, training_params["epochs"]):
        seed_all(seed + epoch)
        print(f"\n{'=' * 25} STARTING EPOCH {epoch} {'=' * 25}\n")
        t1 = time.time()
        epoch_loss, n_batches = 0.0, 0
        # Loss scalars are read once per print_interval, not per step, so
        # the host runs ahead of the device.
        pending: list = []
        for batch_idx, batch in enumerate(train_loader):
            if max_steps_per_epoch and batch_idx >= max_steps_per_epoch:
                break
            # Per-step perturb seed: every step of every epoch draws fresh
            # noise, deterministically per seed.
            step = (epoch * 1_000_003 + batch_idx
                    if perturb is not None else None)
            t0 = time.time()
            loss = train_step(to_device(batch, device), step)
            pending.append(loss)
            n_batches += 1
            if on_step is not None:
                info = {"epoch": epoch, "step": batch_idx,
                        "loss": float(loss), "seconds": time.time() - t0}
                on_step(model, info)
            if batch_idx % print_interval == 0:
                epoch_loss += float(torch.stack(pending).sum())
                pending.clear()
                print(f"Train Epoch {epoch} [{batch_idx}] "
                      f"Loss: {float(loss):.6f}")
        if pending:
            epoch_loss += float(torch.stack(pending).sum())
            pending.clear()
        train_loss = epoch_loss / max(n_batches, 1)
        print(f"Train epoch time: {time.time() - t1:.02f}s  "
              f"loss {train_loss:.4f}")

        # Validation with fixed seed (reference train.py:193-195)
        seed_all(VAL_SEED)
        test_loss, n_test = 0.0, 0
        metrics = []
        for batch_idx, batch in enumerate(test_loader):
            if max_steps_per_epoch and batch_idx >= max_steps_per_epoch:
                break
            pending.append(eval_step(to_device(batch, device)))
            n_test += 1
            if compute_val_metrics:
                metrics.extend(_sisdr_metrics(model, model_name, batch, device))
        if pending:
            test_loss = float(torch.stack(pending).sum())
            pending.clear()
        test_loss /= max(n_test, 1)
        print(f"Test set: Average Loss: {test_loss:.4f}")
        if metrics:
            in_s = np.mean([m["input_si_sdr"] for m in metrics])
            out_s = np.mean([m["si_sdr"] for m in metrics])
            print(f"Average Input SI-SDR: {in_s:.03f}, Output: {out_s:.03f}, "
                  f"SI-SDRi: {out_s - in_s:.03f}")

        _, next_lr = scheduler(lr, epoch, test_loss)
        if next_lr != lr:
            print(f"NEXT learning rate: {next_lr:.08f}")
        lr = next_lr
        for group in optimizer.param_groups:
            group["lr"] = lr

        train_losses.append(train_loss)
        val_losses.append(test_loss)
        val_epochs.append(epoch)
        ckpt.save_params(
            os.path.join(checkpoints_dir,
                         f"{experiment_name}_{epoch}.msgpack"), model)
        # The optimizer state is twice the model's size, so it is saved
        # every SWARM_OPT_STATE_EVERY epochs and at the last one (resume
        # tolerates a fresh optimizer); histories and scheduler state go to
        # the sidecar every epoch.
        save_opt = (epoch % int(os.environ.get("SWARM_OPT_STATE_EVERY", "5"))
                    == 0) or epoch == training_params["epochs"] - 1
        ckpt.save_state(state_path, optimizer if save_opt else None,
                        scheduler.state_dict(), train_losses, val_losses,
                        epoch, lr, val_epochs=val_epochs)
        print(f"\n{'=' * 25} FINISHED EPOCH {epoch} {'=' * 25}\n")

    return train_losses, val_losses


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment_dir", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--print_interval", type=int, default=20)
    parser.add_argument("--max_steps_per_epoch", type=int, default=None,
                        help="cap train/val batches per epoch; with the "
                             "shuffled BatchLoader each capped epoch is a "
                             "fresh random corpus subset")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; raises without "
                             "a card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    train(args.experiment_dir, seed=args.seed,
          print_interval=args.print_interval,
          max_steps_per_epoch=args.max_steps_per_epoch, device=args.device)


if __name__ == "__main__":
    main()
