"""The comparison that decides `correct`: what the timed path produced for a
mixture against what the plain reference works out again from the same
inputs.

Each number is the worst over the mixtures checked, and is held against
its limit in the configuration's file (`limits`):
- `srp_map_err`: the largest gap of the SRP map, over the map's peak;
- `patches0_diff`: stage-0 patches (TDoA offsets and widths) that differ,
  plus the difference of their counts (exact: limit 0);
- `spot_calls_diff`: the difference of the candidates swept through
  SpotNet, the sum of every sweep's decisions (exact: limit 0);
- `heads_diff`: the difference of the head counts (exact: limit 0);
- `head_offset_err`: the largest gap between a head's TDoA offsets and
  those of the reference's head of the same rank (heads come in power
  order), in samples; a head's position follows from its offsets;
- `audio_loc_err`: the largest relative L2 gap of a head's sweep audio;
- `audio_err`: the largest relative L2 gap of a head's separated audio.
Where the two sides' shapes differ (maps of another size), a number reads
NOT_COMPARABLE, far above any limit.

The rule that sets the limits (`limits_from`), from the readings that
`calibrate.py` takes on the card and `benchmark/calibration/<config>.jsonl`
keeps: sound runs (the timed path and its sound variants, float32 that
only sums in other orders) give the lower readings, the controls
(`CONTROLS`, precisions below the configuration's) the upper ones.
- An exact number (`EXACT`) has the limit 0.
- A sound run whose decisions differ from the reference's
  (`decides_otherwise`: an exact number over 0, or two heads of near-equal
  power swapped in rank, so that a head is compared with another
  talker's) reads no precision: it sets no limit, and PERF.md records it.
- A continuous number's (`CONTINUOUS`) lower reading L is its worst over
  every other sound run, every variant and seed; its upper reading U the
  least over the control runs in which it reads SEPARATES times L or more
  (a control that a number cannot see, such as bfloat16 networks for the
  float32 SRP map, sets no upper reading).  Its limit is L^(1/3) U^(2/3),
  rounded to one significant figure: between the two, with two thirds of
  the room, on a log scale, above the lower reading, as fresh seeds read
  higher than the calibration's did.
- The rule holds only if every number has an upper reading and every
  control run exceeds at least one limit by MARGIN times or more (an
  exact number that differs exceeds its 0 without end).  Where it does
  not, the readings cannot set the limits.
"""
from __future__ import annotations

import math

import numpy as np

NOT_COMPARABLE = 1e9
NUMBERS = ("srp_map_err", "patches0_diff", "spot_calls_diff", "heads_diff",
           "head_offset_err", "audio_loc_err", "audio_err")
EXACT = ("patches0_diff", "spot_calls_diff", "heads_diff")
CONTINUOUS = tuple(k for k in NUMBERS if k not in EXACT)
CONTROLS = ("tf32", "bf16")
SEPARATES = 3
MARGIN = 3
# Samples: a head compared with another talker's head reads this much or
# more (talkers lie many samples apart), where rounding reads about 1e-5.
SWAP = 1.0


def heads_of(patches) -> list:
    """The TDoA offsets (M-1,) of each head of the port's and the
    reference's patch tuples."""
    return [np.asarray(p[4]["localization_offset"], np.float64)
            for p in patches]


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return NOT_COMPARABLE
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one mixture.  Both dicts hold `srp_map`, `patches0`
    ((offsets, widths) pairs), `heads` (offsets),
    `audio_loc`, `audio` (None without heads) and `spot_calls`."""
    out = {}
    pm, rm = np.asarray(prog["srp_map"]), np.asarray(ref["srp_map"])
    out["srp_map_err"] = (
        float(np.abs(pm.astype(np.float64) - rm).max()
              / max(float(np.abs(rm).max()), 1e-30))
        if pm.shape == rm.shape else NOT_COMPARABLE)
    p0, r0 = prog["patches0"], ref["patches0"]
    out["patches0_diff"] = NOT_COMPARABLE if p0 is None else abs(
        len(p0) - len(r0)) + sum(
        int(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])))
        for a, b in zip(p0, r0))
    out["spot_calls_diff"] = abs(int(prog["spot_calls"])
                                 - int(ref["spot_calls"]))
    ph, rh = prog["heads"], ref["heads"]
    out["heads_diff"] = abs(len(ph) - len(rh))
    n = min(len(ph), len(rh))
    out["head_offset_err"] = max(
        [float(np.abs(ph[k] - rh[k]).max()) for k in range(n)],
        default=0.0)
    for key in ("audio_loc", "audio"):
        a, b = prog[key], ref[key]
        a = np.zeros((0, 1)) if a is None else np.asarray(a)
        b = np.zeros((0, 1)) if b is None else np.asarray(b)
        out[f"{key}_err"] = max(
            [_rel_l2(a[k], b[k]) for k in range(min(n, len(a), len(b)))],
            default=0.0)
    return out


def worst(readings: list[dict]) -> dict:
    """The largest of each number over the mixtures checked."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)


def round1(x: float) -> float:
    """x rounded to one significant figure."""
    return float(f"{x:.0e}")


def decides_otherwise(numbers: dict) -> bool:
    """Whether a run's decisions differ from the reference's."""
    return (any(numbers[k] > 0 for k in EXACT)
            or numbers["head_offset_err"] >= SWAP)


def limits_from(lines: list[dict]) -> dict:
    """The limits that the rule sets from calibration lines (each with its
    `control` and `numbers`)."""
    sound = [r["numbers"] for r in lines if r["control"] not in CONTROLS
             and not decides_otherwise(r["numbers"])]
    controls = [r["numbers"] for r in lines if r["control"] in CONTROLS]
    out = {k: 0 for k in EXACT}
    for k in CONTINUOUS:
        low = max(n[k] for n in sound)
        seen = [n[k] for n in controls if n[k] >= SEPARATES * low]
        if not seen:
            raise ValueError(f"{k}: no control reads {SEPARATES}x its "
                             f"worst sound reading {low}")
        out[k] = round1(low ** (1 / 3) * min(seen) ** (2 / 3))
    return {k: out[k] for k in NUMBERS}


def margin(numbers: dict, limits: dict) -> float:
    """How many times over its limit the number farthest over it reads."""
    return max(numbers[k] / limits[k] if limits[k]
               else math.inf if numbers[k] > 0 else 0.0 for k in NUMBERS)
