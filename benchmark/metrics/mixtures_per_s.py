"""Completed mixtures over the window: from its start to the last
completion, heads and separated audio both done (and, with a per-mixture
layout, the array set up)."""


def read(run):
    if not run["mixtures"] or run["window_s"] <= 0:
        return None
    return len(run["mixtures"]) / run["window_s"]
