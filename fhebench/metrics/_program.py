"""The program's own spans (``rustfhe_tpu_torch.utils.trace``), for the
per-layer metrics that read them.

Importing this module turns the program's tracer on.  The harness loads a
cell's per-layer metric files, which import this one, only for
``--trace 1`` runs, and loads them before the set-up: so the traced run
records its set-up and its window, and the untraced run, whose host clock
the end-to-end metrics read, runs with the tracer off.  A later benchmark
change may move the switch into the harness.  Where the program has no
tracer (a commit from before it), the import finds nothing, and every
reader here returns None.

Three clocks meet here: a span's ``t0_ns`` and ``t1_ns`` are
``time.perf_counter_ns``; a request's ``Record.t0`` is
``time.perf_counter`` seconds; the profiler's trace has microseconds of
its own.  ``offset_us`` maps the first onto the last: the median, over
the profiled requests, of the trace's start of the k-th
``fhebench.request`` span minus the host clock's start of request
``block + k`` (profiling starts at request ``block``).  A constant: no
drift between the two clocks shows over a five-second sub-window, and
the median passes over the outliers, the first profiled request's offset
(its span opens as the profiler starts) and an occasional late one.
"""

from __future__ import annotations

import statistics

from fhebench.metrics import _trace

try:
    from rustfhe_tpu_torch.utils import trace as tracer
except ImportError:
    tracer = None
else:
    tracer.enable()


def records(run, lo: float | None = None, hi: float | None = None) -> list:
    """The program's spans that lie inside [lo, hi] on the host clock
    (seconds; the measured window [run.start, run.end] by default)."""
    if tracer is None or not run.records:
        return []
    lo = run.start if lo is None else lo
    hi = run.end if hi is None else hi
    lo_ns, hi_ns = lo * 1e9, hi * 1e9
    return [r for r in tracer.records() if lo_ns <= r.t0_ns and r.t1_ns <= hi_ns]


def offsets_us(run) -> list[float]:
    """Per profiled request: the trace's start of its ``fhebench.request``
    span minus its host-clock start, in microseconds."""
    trace = run.trace
    if trace is None:
        return []
    block, recs = run.traffic.block, run.records
    return [s - recs[block + k].t0 * 1e6
            for k, (s, _, _) in enumerate(trace.spans.get("request", [])) if block + k < len(recs)]


def offset_us(run) -> float | None:
    offs = offsets_us(run)
    return statistics.median(offs) if offs else None


def profiled(run, name: str | None = None, pred=None) -> list[tuple[float, float, object]]:
    """The program's spans inside the profiled sub-window, on the trace's
    clock: sorted (start, end, record), those named ``name`` (every name by
    default) whose record passes ``pred``."""
    off = offset_us(run)
    if off is None or tracer is None:
        return []
    t0, t1 = run.trace.t0, run.trace.t1
    out = []
    for r in tracer.records():
        if (name is None or r.name == name) and (pred is None or pred(r)):
            s, e = r.t0_ns / 1e3 + off, r.t1_ns / 1e3 + off
            if t0 <= s and e <= t1:
                out.append((s, e, r))
    out.sort(key=lambda x: (x[0], x[1]))
    return out


def _merged(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e, _ in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def ops_in(run, name: str, pred=None) -> tuple[list, int]:
    """The device operations (start, end, name, correlation) whose launch
    lies inside a profiled ``name`` span passing ``pred``, and the number of
    such spans."""
    spans = profiled(run, name, pred)
    if not spans or not run.trace.ops:
        return [], len(spans)
    cover = _merged(spans)
    launches = run.trace.launches
    return [op for op in run.trace.ops if launches.get(op[3]) is not None
            and _trace._containing(cover, launches[op[3]]) is not None], len(spans)


def idle_by_span(run) -> dict[str, float]:
    """The device's idle seconds in the profiled sub-window by the innermost
    program span open at each gap's middle (``"outside spans"`` where none
    is): ``_trace.breakdown`` with the program's spans in the benchmark's."""
    trace = run.trace
    spans = profiled(run)
    if trace is None or not trace.ops or not spans:
        return {}
    by_name: dict[str, list] = {}
    for s, e, r in spans:
        by_name.setdefault(r.name, []).append((s, e, r.name))
    view = _trace.Trace(trace.t0, trace.t1, trace.ops, trace.launches, by_name)
    return dict(_trace.breakdown(view, top=len(by_name) + 1)["idle_gaps"])
