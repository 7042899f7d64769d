"""Seconds per mixture of the coarse sweep and the subdivision beside it (stage 1): the port's own host-clock
stage time (`JointPipeline.times[1]`), summed over the window's
mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["stage_s"][1] for m in mixtures) / len(mixtures)
