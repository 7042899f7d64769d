"""The port's own records of spans and counters, one per completed
forward (`acousticswarms_speech_tpu_torch.utils.spans`), matched to the
window's mixtures for the metrics that read them."""
from __future__ import annotations

import importlib


def window_records(run: dict):
    """The records of the window's mixtures, oldest first, or None: when
    the port keeps no such records, or when its latest
    `len(run["mixtures"])` records do not carry the window's spot calls,
    mixture by mixture (records of the warm-up, or of another run)."""
    mixtures = run["mixtures"]
    if not mixtures:
        return None
    try:
        spans = importlib.import_module(
            "acousticswarms_speech_tpu_torch.utils.spans")
    except ImportError:
        return None
    records = spans.records()[-len(mixtures):]
    if [r.candidates for r in records] != [m["spot_calls"]
                                           for m in mixtures]:
        return None
    return records


def span_seconds(records: list, name: str) -> float:
    """Seconds per mixture of the spans named `name` over `records`."""
    ns = sum(e - s for r in records for n, _, s, e in r.spans if n == name)
    return ns * 1e-9 / len(records)


def has_span(records: list, name: str) -> bool:
    return any(n == name for r in records for n, *_ in r.spans)
