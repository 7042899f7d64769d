"""Seconds per mixture of the separation network's forward (stage 4): the port's own host-clock
stage time (`JointPipeline.times[4]`), summed over the window's
mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["stage_s"][4] for m in mixtures) / len(mixtures)
