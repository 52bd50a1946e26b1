"""Wrappers the benchmark puts around the port's functions.

Each wrapper replaces a module or class attribute where its callers look
it up, and is taken off again when the run ends:

* ``Capture`` (every run) keeps copies of a seed-drawn sample of the rows
  that go into and come out of the bootstraps the timed path runs, for
  the reference to recompute once the window has closed;
* ``Spans`` (the traced run only) opens a ``torch.profiler``
  ``record_function`` span around each layer's call and counts calls and
  rows per layer.

A probe names an entry point and how to read it: ``kind`` is ``gate``
(pre-combined rows -> lv0 rows), ``gate_lv1`` (the same rotation, stopped
at the lv1 extraction), ``pbs`` or ``pbs_many`` (ciphertext rows and
their tables -> lv0 rows); ``ct`` and ``table`` are the positions of
those arguments.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np
import torch


def resolve(target: str):
    """``"pkg.module:Name.attr"`` -> (the object that holds ``attr``, attr)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


class Patches:
    """Attribute replacements, undone in reverse order by ``restore``."""

    def __init__(self):
        self._undo = []

    def replace(self, target: str, make):
        """Replace ``target`` by ``make(original)``."""
        owner, attr = resolve(target)
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        setattr(owner, attr, make(getattr(owner, attr)))
        self._undo.append((owner, attr, orig))

    def restore(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


def tables_rows(probe: dict, args, lead) -> torch.Tensor | None:
    """A pbs call's tables broadcast to its rows: int64 (rows, t, space)."""
    if probe["kind"] not in ("pbs", "pbs_many"):
        return None
    tab = args[probe["table"]]
    tab = tab if isinstance(tab, torch.Tensor) else torch.from_numpy(np.asarray(tab).astype(np.int64))
    tab = tab.to(torch.int64)
    tail = tab.shape[-1:] if probe["kind"] == "pbs" else tab.shape[-2:]
    tab = tab.expand(tuple(lead) + tuple(tail)).reshape((-1,) + tuple(tail))
    return tab[:, None, :] if probe["kind"] == "pbs" else tab


@dataclass
class Item:
    """One captured slice of a call: rows in, their tables, rows out."""

    kind: str
    ct: torch.Tensor
    out: torch.Tensor
    tables: torch.Tensor | None = None
    space: int = 0
    raw: bool = False


@dataclass
class Capture:
    """Keeps, for a call drawn with probability ``share``, ``rows``
    contiguous rows from a random start, up to ``cap`` rows in all."""

    rng: np.random.Generator
    share: float
    rows: int
    cap: int
    items: list = field(default_factory=list)
    on: bool = False
    kept: int = 0

    def install(self, patches: Patches, probes) -> None:
        for probe in probes:
            patches.replace(probe["target"], lambda fn, probe=probe: self._wrap(fn, probe))

    def _wrap(self, fn, probe):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on and self.kept < self.cap and self.rng.random() < self.share:
                self._keep(probe, args, kwargs, out)
            return out
        return wrapper

    def _keep(self, probe, args, kwargs, out):
        ct = args[probe["ct"]]
        width = ct.shape[-1]
        flat = ct.reshape(-1, width)
        total = flat.shape[0]
        k = min(self.rows, total, self.cap - self.kept)
        start = int(self.rng.integers(0, total - k + 1))
        tail = 2 if probe["kind"] == "pbs_many" else 1
        got = out.reshape((total,) + tuple(out.shape[out.dim() - tail:]))
        tabs = tables_rows(probe, args, ct.shape[:-1])
        self.items.append(Item(
            kind=probe["kind"], ct=flat[start:start + k].clone(),
            out=got[start:start + k].clone().reshape(k, -1, got.shape[-1]),
            tables=None if tabs is None else tabs[start:start + k].clone(),
            space=kwargs.get("space", 0), raw=bool(kwargs.get("raw", False))))
        self.kept += k


@dataclass
class Layer:
    calls: int = 0
    rows: int = 0


class Spans:
    """``record_function`` spans and call/row counts per layer.  Each
    entry of ``targets`` is (span name, target, position of the rows
    argument or None).  A blind rotation's span name carries its rows and
    its test vectors' rows, ``blind_rotate#R#T``, for the roofline."""

    def __init__(self):
        self.layers: dict[str, Layer] = {}

    def install(self, patches: Patches, targets) -> None:
        for name, target, pos in targets:
            patches.replace(target, lambda fn, name=name, pos=pos: self._wrap(fn, name, pos))

    def reset(self) -> None:
        self.layers = {}

    def _wrap(self, fn, name, pos):
        def wrapper(*args, **kwargs):
            rows = 0
            label = name
            if pos is not None:
                x = args[pos]
                rows = int(np.prod(x.shape[:-1]))
                if name == "blind_rotate":
                    tv = args[2]
                    lead = torch.broadcast_shapes(x.shape[:-1], tv.shape[:-2])
                    rows = int(np.prod(lead))
                    label = f"blind_rotate#{rows}#{int(np.prod(tv.shape[:-2]))}"
            layer = self.layers.setdefault(name, Layer())
            layer.calls += 1
            layer.rows += rows
            with torch.profiler.record_function(f"fhebench.{label}"):
                return fn(*args, **kwargs)
        return wrapper


# The layer boundaries the traced run marks: span name, target, rows arg.
SPAN_TARGETS = (
    ("eval_bit", "rustfhe_tpu_torch.apps.replprog:FusedEvaluator.eval_bit", None),
    ("bootstrap_raw", "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", 1),
    ("pbs", "rustfhe_tpu_torch.pbs:pbs", 1),
    ("pbs_many", "rustfhe_tpu_torch.pbs:pbs_many", 1),
    ("blind_rotate", "rustfhe_tpu_torch.bootstrap:blind_rotate", 0),
    ("blind_rotate", "rustfhe_tpu_torch.pbs:blind_rotate", 0),
    ("identity_key_switch", "rustfhe_tpu_torch.bootstrap:identity_key_switch", 0),
    ("identity_key_switch", "rustfhe_tpu_torch.pbs:identity_key_switch", 0),
)
