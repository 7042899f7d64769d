"""The device's idle share of the traced window, in %: 1 minus the union
of the intervals in which an operation ran on the card."""


def read(run):
    summary = run["trace"]
    if summary is None or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
