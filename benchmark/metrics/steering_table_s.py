"""Seconds per mixture of the array's SRP steering table in
`JointPipeline.setup`, built on the host and uploaded (the port's
`array.steering_table` span), from its records of the window's mixtures;
nothing where no mixture set its array up."""
from benchmark.program_records import has_span, span_seconds, window_records

NAME = "array.steering_table"


def read(run):
    records = window_records(run)
    if records is None or not has_span(records, NAME):
        return None
    return span_seconds(records, NAME)
