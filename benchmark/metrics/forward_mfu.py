"""The whole forward's share of the card's peak, in %: the floating-point
operations the networks' calls of the traced window need (SpotNet on
every candidate swept, SepNet once per mixture at its heads, counted from
the call shapes by benchmark/flops.py) over the window's host-clock time,
against the published float32 peak outside the tensor cores (TF32 is off)."""
from benchmark import flops


def read(run):
    peaks = flops.peaks(run["device_name"])
    if peaks is None or not run["sweeps"] or run["window_s"] <= 0:
        return None
    spot, sep = run["config"]["spotnet"], run["config"]["sepnet"]
    total = sum(flops.spotnet_flops(spot, n, M, T) for n, M, T in run["sweeps"])
    total += sum(flops.sepnet_flops(sep, S, M, T)
                 for S, M, T in run["sep_calls"])
    return 100.0 * total / run["window_s"] / peaks["float32_flops"]
