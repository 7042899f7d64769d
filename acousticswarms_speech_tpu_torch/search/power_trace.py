"""Opt-in spot-power tracing for threshold re-tuning.

Host NumPy, copied from the JAX package's `search/power_trace.py` for the PyTorch port
(the port imports nothing of that package).

The coarse/fine spot-power thresholds (constants.SPOT_POWER_THRESHOLD1/2)
gate candidate counts — the dominant cost of the sweep stages — and their
correct values track the trained net's power dynamic range.  With
``ACOUSTIC_TRACE_POWERS=1`` the two decision sites record every candidate's
power statistic; ``pipeline.evaluate`` dumps one ``trace_*.json`` per scene
next to the result JSONs, and ``scripts/tune_thresholds.py`` replays the
threshold decision offline over a value grid (GT retention vs candidate
count) without re-running the pipeline.

Reference counterparts of the decision sites: local_utils_3d.py:339-388
(coarse) and Mic_Array.py:225-300 (fine).  Disabled (the default) this is a
no-op on the hot path.
"""
from __future__ import annotations

import os

ENABLED = os.environ.get("ACOUSTIC_TRACE_POWERS", "0") == "1"

_TRACE: list[dict] = []


def record(stage: str, **data) -> None:
    if ENABLED:
        _TRACE.append({"stage": stage, **data})


def drain() -> list[dict]:
    out = list(_TRACE)
    _TRACE.clear()
    return out
