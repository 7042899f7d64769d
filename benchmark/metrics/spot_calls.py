"""Candidates swept through SpotNet per mixture: the port's own count
(`JointPipeline.spot_model.calls`), summed over the window's mixtures."""


def read(run):
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    return sum(m["spot_calls"] for m in mixtures) / len(mixtures)
