"""From the start of the run to the end of the warm-up: imports, the
networks' weights, the traffic, the array's geometry and the warm-up
forwards."""


def read(run):
    return run["setup_s"]
