"""The stage-1 overlap's reach, in %: of the coarse survivors the fine
stage takes over the window, the share whose subdivision was done beside
the coarse sweep (the port's counters `search.survivors_reused` over
`search.survivors`).  Nothing when a record counts more reused survivors
than subdivisions beside the sweep (`search.subdivided_overlap`), or when
no mixture reached the fine stage."""
from benchmark.program_records import window_records


def read(run):
    records = window_records(run)
    if records is None:
        return None
    counts = [(r.counters.get("search.survivors_reused", 0),
               r.counters.get("search.survivors", 0),
               r.counters.get("search.subdivided_overlap", 0))
              for r in records]
    if any(reused > min(survivors, overlap)
           for reused, survivors, overlap in counts):
        return None
    survivors = sum(c[1] for c in counts)
    if survivors == 0:
        return None
    return 100.0 * sum(c[0] for c in counts) / survivors
