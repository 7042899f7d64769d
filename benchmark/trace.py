"""Reading the traced window from the profiler's events in memory.

The window is the benchmark's own `benchmark.window` span.  Device work is
every event on the card (kernels, copies, sets) but the annotations; its
busy time is the union of their intervals inside the window, and the idle
share is 1 minus that over the window.  Each idle gap is named by the innermost host span
that holds its middle: a stage of `JointPipeline` (its `record_function` spans) or the
benchmark's own spans.
"""
from __future__ import annotations

WINDOW_SPAN = "benchmark.window"
TOP = 10


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, span_names) -> dict | None:
    """`events`: (name, on_device, activity, start_ns, end_ns) tuples;
    `span_names`: the host spans that name idle gaps.  Returns None when the
    window span is missing, else busy_s, window_s, kernel_s (device seconds
    by name), device_ops and idle_gaps (the TOP largest, [name, seconds])."""
    window = [(s, e) for n, dev, _, s, e in events
              if not dev and n == WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0]
    device, kernel_s = [], {}
    for name, dev, activity, s, e in events:
        if not dev or "annotation" in activity:
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        device.append((s, e))
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) * 1e-9
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    spans = sorted((s, e, n) for n, dev, _, s, e in events
                   if not dev and n in span_names)
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    named = []
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inner = [n for s, e, n in spans if s <= mid < e]
        named.append([inner[-1] if inner else "between_stages",
                      (g1 - g0) * 1e-9])
    named.sort(key=lambda x: -x[1])
    ops = sorted(kernel_s.items(), key=lambda x: -x[1])[:TOP]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-9,
            "kernel_s": kernel_s,
            "device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": named[:TOP]}


def profiler_events(prof, span_names=()):
    """The (name, on_device, activity, start_ns, end_ns) tuples of a
    finished `torch.profiler.profile`.  A device event named like a host
    span (`span_names`, the window, or a host user annotation) is the
    span's mark on the device's timeline, and its activity reads
    "annotation"."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    marks = {WINDOW_SPAN, *span_names}
    for e in events:
        if e.device_type() != DeviceType.CUDA and getattr(
                e, "is_user_annotation", lambda: False)():
            marks.add(e.name())
    out = []
    for e in events:
        start = e.start_ns()
        on_device = e.device_type() == DeviceType.CUDA
        activity = str(getattr(e, "activity_type", lambda: "")())
        if on_device and e.name() in marks:
            activity = "gpu_user_annotation"
        out.append((e.name(), on_device, activity, start,
                    start + e.duration_ns()))
    return out
