"""Seconds per mixture of the array's TDoA geometry in `JointPipeline.setup`
(the port's `array.geometry` span, a cache load included), from its records
of the window's mixtures; nothing where no mixture set its array up."""
from benchmark.program_records import has_span, span_seconds, window_records

NAME = "array.geometry"


def read(run):
    records = window_records(run)
    if records is None or not has_span(records, NAME):
        return None
    return span_seconds(records, NAME)
