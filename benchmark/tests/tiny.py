"""A cell small enough for the CPU: narrow networks with seeded weights,
0.5 s mixtures of 2 talkers, a 0.1 m grid and a 0.25 s selection crop."""
import copy
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPOT = dict(channels=8, encoder_channels=32, residual_layers=1, num_head=2,
            ffw_dim=16, num_transformer_layers=1)
SEP = dict(max_speakers=5, channels=8, encoder_channels=32, residual_layers=1,
           num_head=2, ffw_dim=16, bottleneck_layers=1, bottleneck_ksize=7)


def config(name: str = "release7") -> dict:
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    n = cfg["n_mics"]
    cfg.update(grid_size=0.1, sweep_crop_seconds=0.25)
    cfg["spotnet"]["model_params"] = dict(SPOT, n_mics=n)
    cfg["sepnet"]["model_params"] = dict(SEP, n_mics=n)
    cfg["weights"] = {"kind": "seeded", "seeds": {"spotnet": 1, "sepnet": 2}}
    return cfg


def traffic(name: str = "table_5talkers", pool: int = 4) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        tr = json.load(f)
    tr.update(talkers=2, seconds=0.5, voices=3, pool=pool, warmup=1)
    tr["scenes"] = pool if tr["layout"] == "per_mixture" else 1
    return tr


def spec(config_name="release7", traffic_name="table_5talkers", pool=4):
    from benchmark import harness

    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = {"name": "tiny", "config": config_name, "traffic": traffic_name,
            "chips": 1}
    return {"cell": cell, "config": config(config_name),
            "traffic": traffic(traffic_name, pool),
            "end_to_end": copy.deepcopy(manifest["end_to_end"]),
            "per_layer": [m for m in copy.deepcopy(manifest["per_layer"])
                          if "workloads" not in m]}
