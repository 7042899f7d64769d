"""Readings of the compared numbers, from which the limits are set: sound
runs of the port (the lower readings) and runs of its controls, the port
in a precision below the configuration's (the upper readings), on several
seeds in one process.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \
        --controls none,cudnn_bench,cublaslt,split_k,norm_order,tf32,bf16 \
        --seconds 10

Each run is the cell's own run (`harness.run_cell`) with a short window
that runs on until as many mixtures have ended as a run checks, no
warm-up, and the window's first mixture drawn from the seed, so that the
seeds' windows spread over the pool; one JSON line per run on standard
output: workload, seed, control, correct (under the limits of the time),
the mixtures started and failed, the window's first mixture and the
numbers.  `benchmark/calibration/<config>.jsonl` keeps the lines that
the configuration's limits were set from, by the rule in `check.py`.

Sound runs are float32 with TF32 off, as the configurations state: `none`
is the timed path itself, and each sound variant runs the same operations
on the same values and only has the card sum them in another order, as a
faster kernel of a later change would:
- `cudnn_bench`: cuDNN's benchmark mode.  For each convolution shape cuDNN
  times its float32 algorithms (implicit GEMMs with other tiles and splits,
  FFT, Winograd) and keeps the fastest, where the default takes its
  heuristic's pick.  TF32 stays off, so each computes the convolution in
  float32 and they differ in how the products are summed.
- `cublaslt`: every matrix product (the linear layers, attention, the GEMM
  forms of the mask encoders and the upsampling, the SRP map's steering
  product) through cuBLASLt in place of cuBLAS: other float32 kernels,
  tiles and splits of the same sums.
- `split_k`: every `F.conv1d` of one group (SpotNet's and SepNet's
  convolutions on cuDNN) sums its input channels in two halves, each a
  convolution of its own, adds the halves and then the bias: each product
  once, the sum split in two as a split-K kernel splits it.
- `norm_order`: K5's and K6's epilogues (the residual layers' bias, ReLU,
  residual and LayerNorm; the blocks' bias or gate, GroupNorm(2) and GLU)
  as float32 compositions that take each mean and variance in two passes,
  the sum and then the sum of squared deviations, where K5 and K6 follow
  torch's Welford order: the statistics of the same values, summed in
  another order.
None changes a precision, skips work or changes a decision rule: the
patches, spot calls and heads follow from the values and stay exact.

The controls: `tf32` lets matmuls and cuDNN use TF32 (the nearest
precision below float32 with TF32 off); `bf16` is the port's bfloat16
path.  Each variant and control is switched on from the benchmark's side
(`depart`) before the program is built and off again once the window has
closed, before the reference runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.nn import functional as F

from .check import CONTROLS

SOUND = ("cudnn_bench", "cublaslt", "split_k", "norm_order")
# The window of a calibration run finishes fewer mixtures than this, so its
# first mixture is drawn from the pool's first `pool - SPAN + 1`.
SPAN = 8


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _cudnn_bench():
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True

    def undo():
        torch.backends.cudnn.benchmark = before
    return undo


def _cublaslt():
    before = torch.backends.cuda.preferred_blas_library()
    torch.backends.cuda.preferred_blas_library("cublaslt")
    return lambda: torch.backends.cuda.preferred_blas_library(before)


def _split_k():
    conv1d = F.conv1d

    def split(input, weight, bias=None, stride=1, padding=0, dilation=1,
              groups=1):
        half = weight.shape[1] // 2
        if groups != 1 or half == 0:
            return conv1d(input, weight, bias, stride, padding, dilation,
                          groups)
        y = (conv1d(input.narrow(-2, 0, half), weight[:, :half], None,
                    stride, padding, dilation)
             + conv1d(input.narrow(-2, half, input.shape[-2] - half),
                      weight[:, half:], None, stride, padding, dilation))
        return y if bias is None else y + bias[:, None]

    F.conv1d = split

    def undo():
        F.conv1d = conv1d
    return undo


def _two_pass(x: torch.Tensor, dim: int, eps: float):
    """x normalised over `dim`: mean, then the mean square of the
    deviations, each a plain float32 sum."""
    mean = x.sum(dim, keepdim=True) / x.shape[dim]
    d = x - mean
    return d * torch.rsqrt((d * d).sum(dim, keepdim=True) / x.shape[dim]
                           + eps)


def residual_epilogue_two_pass(z, x, conv_bias, norm_weight, norm_bias, eps):
    """K5's function, LN_C(relu(z + conv_bias) + x) * w + b, with its
    statistics in two passes."""
    y = F.relu(z + conv_bias[:, None]) + x
    return (_two_pass(y, 1, eps) * norm_weight[None, :, None]
            + norm_bias[None, :, None])


def block_epilogue_two_pass(e, norm_weight, norm_bias, eps, bias=None,
                            gate=None):
    """K6's function, glu(GroupNorm(2)(pre(e))), with GroupNorm's
    statistics in two passes."""
    if bias is not None:
        e = e + bias[:, None]
    if gate is not None:
        e = gate[:, :, None] * e
    B, C2, T = e.shape
    n = _two_pass(e.reshape(B, 2, C2 // 2 * T), 2, eps).reshape(B, C2, T)
    a, b = (n * norm_weight[None, :, None]
            + norm_bias[None, :, None]).chunk(2, dim=1)
    return a * torch.sigmoid(b)


def _norm_order():
    from acousticswarms_speech_tpu_torch.models import modules

    kernels = modules.residual_epilogue_cuda, modules.block_epilogue_cuda
    modules.residual_epilogue_cuda = residual_epilogue_two_pass
    modules.block_epilogue_cuda = block_epilogue_two_pass

    def undo():
        modules.residual_epilogue_cuda, modules.block_epilogue_cuda = kernels
    return undo


_SOUND = {"cudnn_bench": _cudnn_bench, "cublaslt": _cublaslt,
          "split_k": _split_k, "norm_order": _norm_order}


def depart(control: str | None):
    """Switch on the sound variant or control `control` (None: the timed
    path as it is) and return the function that switches it off.  `bf16`
    is the program's own option, which `harness.build_program` sets."""
    if control in (None, "bf16"):
        return lambda: None
    if control == "tf32":
        _tf32(True)
        return lambda: _tf32(False)
    if control not in _SOUND:
        raise ValueError(f"no control or sound variant {control!r}: "
                         f"{('none',) + SOUND + CONTROLS}")
    return _SOUND[control]()


def window_start(seed: int, pool: int) -> int:
    """The first mixture of a calibration window, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    return int(rng.integers(0, max(1, pool - SPAN + 1)))


def readings(workload: str, seeds, control: str | None, seconds: float,
             device="cuda"):
    """One dict per seed: workload, seed, control, correct, attempted,
    failed, first (the window's first mixture) and numbers."""
    from benchmark import harness

    out = []
    for seed in seeds:
        spec = harness.cell_spec(workload)
        spec["traffic"]["warmup"] = 0
        spec["end_to_end"] = spec["per_layer"] = []
        first = window_start(seed, spec["traffic"]["pool"])
        result = harness.run_cell(spec, seed, seconds, False, device,
                                  time.perf_counter(), control=control,
                                  first=first, least=harness.CHECKED)
        out.append({"workload": workload, "seed": seed,
                    "control": control or "none",
                    "correct": result["correct"],
                    "attempted": result["attempted"],
                    "failed": result["failed"], "first": first,
                    "numbers": {k: v["value"]
                                for k, v in result["check"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="none")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    _tf32(False)
    for control in args.controls.split(","):
        readings(args.workload, seeds, None if control == "none" else control,
                 args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
