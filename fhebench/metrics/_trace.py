"""Reading the traced run's ``torch.profiler`` trace.

The harness wraps the profiled sub-window in a ``fhebench.profiled`` span,
each request in ``fhebench.request`` and each layer's call in
``fhebench.<layer>`` (``hooks.Spans``), then exports the trace as Chrome
JSON.  Here the device's operations (kernels, copies, sets) are read with
the host-side launch each came from (by the correlation id), so that a
kernel's time is charged to the span its launch lies in.  Times are
seconds; a reader that finds nothing returns None.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    t0: float  # the profiled window, in the trace's microseconds
    t1: float
    ops: list  # (start, end, name, correlation) of every device operation in the window
    launches: dict  # correlation -> the launch's host timestamp
    spans: dict = field(default_factory=dict)  # layer -> sorted [(start, end, label)]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6


def load(path: str) -> Trace | None:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    spans: dict[str, list] = {}
    ops, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((ts, ts + dur, name, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation" and name.startswith("fhebench."):
            label = name[len("fhebench."):]
            if label == "profiled":
                window = (ts, ts + dur)
            else:
                spans.setdefault(label.split("#")[0], []).append((ts, ts + dur, label))
    if window is None:
        return None
    for v in spans.values():
        v.sort()
    ops = [o for o in ops if o[1] > window[0] and o[0] < window[1]]
    ops.sort()
    return Trace(window[0], window[1], ops, launches, spans)


def busy(trace: Trace) -> list[tuple[float, float]]:
    """The device's busy intervals in the window, merged."""
    out: list[list[float]] = []
    for s, e, _, _ in trace.ops:
        s, e = max(s, trace.t0), min(e, trace.t1)
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy(trace)) / 1e6


def _containing(intervals: list, t: float):
    """The interval of a sorted, non-overlapping list that holds t, or None."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i]
    return None


def device_s_in(trace: Trace, layer: str) -> float:
    """Device seconds of the operations launched inside ``layer``'s spans."""
    spans = trace.spans.get(layer, [])
    total = 0.0
    for s, e, _, corr in trace.ops:
        t = trace.launches.get(corr)
        if t is not None and _containing(spans, t) is not None:
            total += e - s
    return total / 1e6


def rotate_roofline_pct(run) -> float | None:
    """The least time of the blind rotations in the window (``_roofline``)
    over the device time of every operation launched inside their spans."""
    from . import _roofline

    trace = run.trace
    if trace is None:
        return None
    dev = device_s_in(trace, "blind_rotate")
    if dev <= 0:
        return None
    least = 0.0
    for _, _, label in trace.spans.get("blind_rotate", []):
        _, rows, tv_rows = label.split("#")
        least += _roofline.rotation_least_s(run.params, int(rows), int(tv_rows))
    return 100.0 * least / dev


def share_pct(run, layer: str) -> float | None:
    """Device time inside ``layer``'s spans over the window's busy time."""
    trace = run.trace
    if trace is None:
        return None
    b = busy_s(trace)
    return None if b <= 0 else 100.0 * device_s_in(trace, layer) / b


def idle_pct(run) -> float | None:
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    b = busy_s(trace)
    return None if b <= 0 else 100.0 * (1.0 - b / trace.window_s)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    innermost span the host was in at each gap's middle."""
    by_op: dict[str, float] = {}
    for s, e, name, _ in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + (min(e, trace.t1) - max(s, trace.t0)) / 1e6
    gaps: dict[str, float] = {}
    edges = [trace.t0] + [t for iv in busy(trace) for t in iv] + [trace.t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid, best = (s + e) / 2, None
        for layer, spans in trace.spans.items():
            iv = _containing(spans, mid)
            if iv is not None and (best is None or iv[1] - iv[0] < best[1] - best[0]):
                best = (iv[0], iv[1], layer)
        label = best[2] if best else "outside spans"
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(gaps)]}
