"""Seconds per mixture of the SRP map and its pruning (stage 0): the port's own host-clock
stage time (`JointPipeline.times[0]`), summed over the window's
mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["stage_s"][0] for m in mixtures) / len(mixtures)
