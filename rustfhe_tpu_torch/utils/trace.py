"""Spans inside the port, behind one switch that is off by default.

``span(name, **attrs)`` marks one piece of the port's work with ``with``.
Off (the default; no environment variable turns it on) it returns one
shared no-op object after a single global read: no record, no object of
its own.  On (``enable()``), while a profiler runs
(``utils.timing.profile_trace``), it opens
``torch.profiler.record_function("rustfhe.<name>")``, so the profiler
shows the span above the kernels it launched, on the device trace's own
clock; with no profiler running it skips that pair, which costs some
10 us a span on a CPU host.  When it closes it appends one ``Record`` to
an in-memory list.

A record holds its ``id``, its ``parent`` (the span open around it on the
same thread, or None), its ``root`` (the outermost span open on the
thread: every span of one call into the port shares it), its ``name``,
``t0_ns`` and ``t1_ns`` (``time.perf_counter_ns``) and its ``attrs``.
Counts (rows, padding rows, steps) are attributes of the span where the
work happens, so any time window can be cut from the records.  Each
thread keeps its own stack of open spans.  The list holds at most
``CAP`` records; ``dropped()`` counts those beyond.

Call sites pass attributes no dearer than a shape read; a dearer one is
computed only under ``if trace.enabled():`` and added with ``set``.

Spans of the port (name: where; attributes):

* ``evaluate``: ``apps.circuits.evaluate_encrypted``; ``lanes``, ``levels``
* ``evaluate.plan``: its ``optimize``, ``_level_plan`` and uploads; ``gates``
* ``evaluate.level``: one a level; ``rows`` (width x lanes), ``pad_rows``
* ``bootstrap``: ``bootstrap.bootstrap``, and a rank's rows in
  ``parallel.sharded``; ``rows``
* ``pbs``: ``pbs.pbs``, ``pbs.pbs_many``; ``rows``, ``tables`` (lookups a row)
* ``pbs.prepare``: in ``pbs.pbs`` and ``pbs.rotate_extract_many``, the
  half-bucket offset, the coarse modulus switch (t > 1) and the test
  vector's build; ``rows``, ``tv_rows`` (the test vectors built), ``t``
* ``extract``: the sample extraction(s) after a rotation, in
  ``bootstrap.gate_bootstrapping_tlwe2tlwe``, a rank's rows in
  ``parallel.sharded``, ``pbs.pbs`` and ``pbs.rotate_extract_many``;
  ``rows``, ``t`` (coefficients extracted a row)
* ``blind_rotate``: ``bootstrap.blind_rotate``; ``rows``, ``tv_rows``,
  ``path`` (``k1``, ``k3``, ``hybrid``, ``limb``, ``generic``), ``steps``
  (n, 1 for K3's single launch), ``calls`` (the host calls that issued the
  steps: 1 for K1 and K3, ``steps`` for the loops), and on K1 alone
  ``product`` (``karatsuba`` or ``schoolbook``: the step that
  ``engine.cmux_k.cmux_rotate`` took, set by it)
* ``key_switch``: ``bootstrap.identity_key_switch``, and the sharded key
  switches of ``parallel.sharded``; ``rows``
* ``collective``: every collective of ``parallel/`` (``parallel.mesh.collective``);
  ``op``, ``ranks`` (the group's size), ``bytes`` (those that cross cards at
  this rank)
* ``setup.kernels``: ``engine.build.load``, a library's first load;
  ``library``, ``built``
* ``setup.engine_probe``: ``engine.select_engine``; ``engine``
* ``setup.keys``: ``keys.from_jax_keys``, ``keys.gen_keys``,
  ``keys.cloud_key_latency``; ``engine``
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

CAP = 1 << 20

_on = False
_records: list = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class Record(NamedTuple):
    id: int
    parent: int | None
    root: int
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


class _Off:
    """The shared span of the switched-off tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        return None


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._fn = None
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function("rustfhe." + self.name)
            self._fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _stack().pop()
        _keep(Record(self.id, self.parent, self.root, self.name, self.t0, t1, self.attrs))
        return None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: Record) -> None:
    global _dropped
    if len(_records) < CAP:
        _records.append(rec)
    else:
        _dropped += 1


def span(name: str, **attrs):
    """A context manager around one piece of the port's work: the shared
    no-op ``OFF`` while the tracer is off, else a recording span."""
    if not _on:
        return OFF
    return _Span(name, attrs)


def enable(on: bool = True) -> None:
    """Turn the tracer on (or, with ``on=False``, off)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def records() -> list[Record]:
    """The closed spans kept so far, in the order they closed."""
    return list(_records)


def dropped() -> int:
    """Closed spans not kept because the list held ``CAP`` records."""
    return _dropped


def clear() -> None:
    """Forget every kept record and the count of dropped ones."""
    global _dropped
    _records.clear()
    _dropped = 0
