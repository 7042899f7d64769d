"""Seconds per mixture of the fine sweep, its clustering and the heads' full-length sweep (stage 2): the port's own host-clock
stage time (`JointPipeline.times[2]`), summed over the window's
mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["stage_s"][2] for m in mixtures) / len(mixtures)
