"""Throughput mode: software-pipelined evaluation of independent mixtures
(JAX: pipeline/throughput.py).

Each mixture's wall time splits into host work (SRP peak picking, patch
subdivision, NMS, consistency scoring, result IO, which leave the card
idle) and device work (SRP map, sweeps, separation).  Scenes are
independent, so this runner drives N *lanes* (default 2) from worker
threads: while lane A waits on the card, lane B's host stages run.

Every lane is a `JointPipeline` view that shares the two networks, their
executors and the device with the original, and owns its stage state
(`MicArray`, stage times) and its own count of spot calls, so two mixtures
in flight never touch each other's bookkeeping.

Unlike the JAX package's runner, once one item fails no lane claims a new
item, and `run` raises the first error after the lanes have stopped.
"""
from __future__ import annotations

import threading
import time

from ..search.spotform import SweepLane
from .joint import JointPipeline


def make_lane(pipe: JointPipeline) -> JointPipeline:
    """A pipeline view sharing `pipe`'s networks, executors, device and
    every other attribute, with its own per-mixture stage state (`times`,
    `previous_config`, `mic_processor`) and its own spot-call count.

    The lane starts from a copy of `pipe.__dict__`, so an attribute added
    to the pipeline (in `__init__` or later) reaches every lane."""
    lane = type(pipe).__new__(type(pipe))
    lane.__dict__.update(pipe.__dict__)
    lane.spot_model = SweepLane(getattr(pipe.spot_model, "executor",
                                        pipe.spot_model))
    lane.times = [0.0] * 5
    lane.previous_config = None
    lane.mic_processor = None
    return lane


class PipelinedRunner:
    """Run many independent mixtures through `n_lanes` pipeline lanes.

    `setup_fn(lane)` is called once per lane.  A pipeline may provide its
    own `make_lane()`.  `run` keeps input order in its results and reports
    per-lane utilization.
    """

    def __init__(self, pipe: JointPipeline, n_lanes: int = 2,
                 setup_fn=None):
        self.lanes = [pipe]
        clone = getattr(pipe, "make_lane", None) or (lambda: make_lane(pipe))
        for _ in range(n_lanes - 1):
            self.lanes.append(clone())
        if setup_fn is not None:
            for lane in self.lanes:
                setup_fn(lane)

    def run(self, mixtures, work_fn=None):
        """`mixtures`: sequence of (M, T) arrays (or of arbitrary work items
        when `work_fn(lane, item, index)` is given).  Default work is
        `lane.forward(item)`.  Returns (results_in_order, stats)."""
        n = len(mixtures)
        results = [None] * n
        errors: list[BaseException] = []
        next_idx = [0]
        lock = threading.Lock()
        busy = [0.0] * len(self.lanes)

        def worker(lane_id):
            lane = self.lanes[lane_id]
            while True:
                with lock:
                    i = next_idx[0]
                    if i >= n or errors:
                        return
                    next_idx[0] = i + 1
                t0 = time.time()
                try:
                    if work_fn is not None:
                        results[i] = work_fn(lane, mixtures[i], i)
                    else:
                        results[i] = lane.forward(mixtures[i])
                except BaseException as e:  # noqa: BLE001 (re-raised by run)
                    with lock:
                        errors.append(e)
                    return
                finally:
                    busy[lane_id] += time.time() - t0

        t_start = time.time()
        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(len(self.lanes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t_start
        if errors:
            raise errors[0]
        stats = {
            "wall_s": wall,
            "n": n,
            "mixtures_per_sec": n / wall if wall > 0 else 0.0,
            "lane_busy_s": list(busy),
            "lane_utilization": [b / wall if wall > 0 else 0.0 for b in busy],
        }
        return results, stats
