"""Seconds per mixture of the final non-max suppression (stage 3): the port's own host-clock
stage time (`JointPipeline.times[3]`), summed over the window's
mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["stage_s"][3] for m in mixtures) / len(mixtures)
