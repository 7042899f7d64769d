"""Separation train-step time and peak device memory at several batch sizes
(JAX: scripts/probe_sep_batch.py).

The separation recipe trains at batch 1.  This probes whether batch 2 or 4
fits with remat on, and what the time per sample does: if batch B steps in
less than B times the batch-1 time, a larger batch buys epochs per hour.
The network is built from the experiment's description with weights from
`init_model`'s seeded generator, and trained by the port's `make_step_fns`
on random data of the training shapes (n_mics * max_speakers input
channels, crop_seconds * sr samples).  Each size times one step, then four,
and reports the fastest of the four.  An out-of-memory error at one size is
reported as `B=<n>: FAILED ...` and the probe goes on; any other error
propagates.

    python -m acousticswarms_speech_tpu_torch.scripts.probe_sep_batch \
        [batch_sizes ...] [--experiment experiments/speech_separation] \
        [--device cuda]

Peak memory is `torch.cuda.max_memory_allocated` over the size's steps,
"n/a" on the CPU.  The device defaults to cuda; without a card it raises
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.factory import create_model, init_model
from ..training.experiment import read_description
from ..training.train import make_step_fns, to_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe(sizes, experiment: str, device=None, seed: int = 0) -> list[dict]:
    """One row per batch size: {"batch", "step_s", "step_s_per_sample",
    "first_step_s", "peak_gb" (None on the CPU), "failed" (None or the
    error)}; each row is printed as it is measured."""
    device = resolve_device(device)
    desc = read_description(experiment)
    model_params = desc["model_params"]
    training_params = desc["training_params"]
    sr = desc["sr"]
    tc = int(desc["train_set_params"]["crop_seconds"] * sr)
    n_mics = model_params["n_mics"]
    n_spk = model_params["max_speakers"]

    model = init_model(create_model("SpeakerSeparation", model_params),
                       seed=seed).to(device)
    _, train_step, _ = make_step_fns(
        model, "SpeakerSeparation", training_params["loss"],
        training_params["gradient_clip"], training_params["lr"])

    rng = np.random.default_rng(seed)
    rows = []
    for B in sizes:
        data = rng.standard_normal((B, n_mics * n_spk, tc)).astype(
            np.float32) * 0.1
        gt = rng.standard_normal((B, n_spk, tc)).astype(np.float32) * 0.1
        ns = np.full((B,), n_spk, np.int64)
        row = {"batch": B, "step_s": None, "step_s_per_sample": None,
               "first_step_s": None, "peak_gb": None, "failed": None}
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        try:
            batch = to_device((data, gt, ns), device)
            t0 = time.perf_counter()
            train_step(batch)
            _sync(device)
            row["first_step_s"] = time.perf_counter() - t0
            ts = []
            for _ in range(STEPS):
                t0 = time.perf_counter()
                train_step(batch)
                _sync(device)
                ts.append(time.perf_counter() - t0)
            row["step_s"] = min(ts)
            row["step_s_per_sample"] = row["step_s"] / B
            if device.type == "cuda":
                row["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            peak = ("n/a" if row["peak_gb"] is None
                    else f"{row['peak_gb']:.2f} GB")
            print(f"B={B}: step {row['step_s']:.3f}s "
                  f"({row['step_s_per_sample']:.3f}s/sample), first step "
                  f"{row['first_step_s']:.1f}s, peak memory {peak}",
                  flush=True)
        except torch.cuda.OutOfMemoryError as e:
            row["failed"] = f"{type(e).__name__}: {str(e)[:200]}"
            print(f"B={B}: FAILED {row['failed']}", flush=True)
        finally:
            batch = None
            for p in model.parameters():
                p.grad = None
        rows.append(row)
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sizes", type=int, nargs="*", default=[1, 2, 4])
    parser.add_argument("--experiment", default=os.path.join(
        REPO, "experiments", "speech_separation"))
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a "
                             "card unless 'cpu' is given)")
    args = parser.parse_args(argv)
    probe(args.sizes or [1, 2, 4], args.experiment, args.device)


if __name__ == "__main__":
    main()
