"""Seconds per mixture of `JointPipeline.setup` for the mixture's own
array (geometry, steering table), from the benchmark's span around it;
nothing where the array is fixed."""


def read(run):
    times = [m["array_setup_s"] for m in run["mixtures"]
             if m["array_setup_s"] is not None]
    if not times:
        return None
    return sum(times) / len(run["mixtures"])
