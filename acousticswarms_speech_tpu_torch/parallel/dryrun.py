"""Multi-rank dry run of the sharded programs (JAX: __graft_entry__.py
dryrun_multichip).

    python -m acousticswarms_speech_tpu_torch.parallel.dryrun --n_devices N
        [--device cuda|cpu] [--backend nccl|gloo]

Launches N ranks on a mesh of n_data = 2 rows when N is even (else 1) and
runs, on a narrow SpotNet with the full architecture:
1. the data-parallel train step, the batch split over all N ranks;
2. a candidate-sharded SpotformExecutor sweep with the SI-SDR matrix (what
   JointPipeline(mesh=...) runs for its coarse and fine stages);
3. the grid-sharded SRP-PHAT map.
Each rank checks shapes and finiteness.  The exit code is 1 when a rank
fails (its traceback is printed) and 0 otherwise.  `--device` defaults to
cuda and `--backend` to nccl on cuda and gloo on the CPU; nccl needs one
GPU per rank.
"""
from __future__ import annotations

import argparse
import sys
import traceback

import numpy as np
import torch

from .mesh import launch, make_mesh, shard_srp_map, shard_train_step

# JAX: __graft_entry__.py:127-129
SPOT_PARAMS = dict(n_mics=7, stride_list=(2, 2, 4), channels=8,
                   encoder_channels=32, residual_layers=1, ffw_dim=16,
                   num_transformer_layers=1, num_head=2)


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank of the dry run; returns its loss and output shapes."""
    from ..models import SpotNet
    from ..models.factory import init_model
    from ..ops.srp import build_steering_table, srp_phat_map
    from ..search.spotform import SpotformExecutor

    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_data, n_devices // n_data, device)
    model = init_model(SpotNet(**SPOT_PARAMS), seed=0).to(device)
    M, T = 7, 512
    B = max(n_devices, 2)
    rng = np.random.default_rng(0)

    # 1) data-parallel train step
    _, step = shard_train_step(mesh, model, "SpeakerLocalization", "fused",
                               gradient_clip=1.0, lr=1e-3)
    batch = tuple(torch.as_tensor(x, device=device) for x in (
        rng.normal(size=(B, M, T)).astype(np.float32),
        rng.normal(size=(B, 1, T)).astype(np.float32),
        np.tile([[1.0, 0.0]], (B, 1)).astype(np.float32)))
    loss = float(step(batch))
    if not np.isfinite(loss):
        raise AssertionError(f"train step loss {loss}")

    # 2) candidate-sharded sweep through the production executor
    K = 2 * n_devices
    mix = rng.normal(size=(M, T)).astype(np.float32)
    patch_list = [rng.integers(-10, 10, size=M - 1) for _ in range(K)]
    res = SpotformExecutor(model, device=device, mesh=mesh).sweep(
        mix, patch_list, strict=1, with_similarity=True)
    out = np.stack(list(res.gather(range(K), quantize=False).values()))
    if not (res.powers.shape == (K,) and np.isfinite(res.powers).all()
            and res.sisdr_mat.shape == (K, K) and out.shape == (K, T)
            and np.isfinite(out).all()):
        raise AssertionError(f"sweep: powers {res.powers}, sisdr "
                             f"{res.sisdr_mat.shape}, out {out.shape}")

    # 3) grid-sharded SRP map
    G = 8 * n_devices
    grids = np.concatenate([rng.uniform(-2, 2, size=(G, 2)),
                            rng.uniform(0.1, 0.5, size=(G, 1))], axis=1)
    mic_pos = np.concatenate([rng.uniform(-0.5, 0.5, size=(M, 2)),
                              np.zeros((M, 1))], axis=1)
    bins, nfft = np.arange(2, 10), 256
    tables = build_steering_table(grids, mic_pos, bins, 48000, nfft)
    srp = shard_srp_map(mesh, lambda s, re, im, b: srp_phat_map(
        s, re, im, b, window=T // 2, nfft=nfft, hop=nfft // 4))
    m = srp(*(torch.as_tensor(x, device=device)
              for x in (mix, *tables, bins))).cpu().numpy()
    if not (m.shape == (G,) and np.isfinite(m).all()):
        raise AssertionError(f"srp map {m.shape}")
    return {"rank": mesh.rank, "mesh": [n_data, n_devices // n_data],
            "loss": loss, "sweep": list(out.shape), "srp_map": list(m.shape)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_devices", type=int, required=True)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = parser.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    try:
        results = launch(dryrun_rank, args.n_devices, backend, args.device,
                         args=(args.n_devices,))
    except Exception:  # noqa: BLE001 (the CLI's boundary: report, exit 1)
        traceback.print_exc()
        return 1
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        print(f"ranks disagree on the train step's loss: {results}",
              file=sys.stderr)
        return 1
    r = results[0]
    print(f"dryrun({args.n_devices}, {args.device}, {backend}): mesh "
          f"{r['mesh']}, train step loss {r['loss']:.4f}, sweep {r['sweep']}, "
          f"srp map {r['srp_map']} — OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
