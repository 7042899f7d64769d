"""Seconds per mixture of the host's subdivision of coarse survivors
(the port's `search.subdivide` spans, beside the coarse sweep and in the
fine stage), from its records of the window's mixtures."""
from benchmark.program_records import span_seconds, window_records


def read(run):
    records = window_records(run)
    if records is None:
        return None
    return span_seconds(records, "search.subdivide")
