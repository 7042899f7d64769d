"""Seconds per mixture the host waited on the device in its blocking
reads of device results (the port's `device.wait` spans: the SRP map, the
sweeps' powers and SI-SDR matrix, the heads' waveforms, the separated
audio), from its records of the window's mixtures."""
from benchmark.program_records import span_seconds, window_records


def read(run):
    records = window_records(run)
    if records is None:
        return None
    return span_seconds(records, "device.wait")
