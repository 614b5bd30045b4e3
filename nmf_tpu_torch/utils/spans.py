"""Spans and counters inside the port: where a solve spends its host time,
where it reads the card back, and where it launches the port's kernels.

Off by default.  A caller turns recording on for a block on its own thread
and reads the records from memory::

    from nmf_tpu_torch.utils import spans

    with spans.recording() as rec:
        nt.nnmf(X, k, ...)
    for s in rec.spans:
        print(s.name, s.end_ns - s.start_ns, s.parent, s.call, s.attrs, s.counts)

Each record (``Span``) has a ``name``, ``start_ns`` and ``end_ns``
(``time.time_ns()``: the Unix-epoch nanoseconds that ``torch.profiler``
stamps its events with, so a span and a kernel of a device trace lie on one
timeline), ``parent`` (the index in ``rec.spans`` of the enclosing span, or
None), ``call`` (an id shared by every span of one ``nnmf`` call, None
outside one), ``attrs`` (a small dict) and ``counts``: ``host_reads``, the
deliberate reads of the card made while it was the innermost open span
(``host_read``), and ``launches``, the port's kernel launches made so
(``ops/cuda/build.launch``).  The spans, from the front door down:

- ``nnmf`` (attrs ``alg``, ``k``, ``replicates``, ``parallel``) with
  ``nnmf.checks``, ``nnmf.init`` and ``replicates`` (the restarts after the
  first solve: ``replicates.draw``, ``replicates.lanes``);
- ``solve`` with ``solve.prepare``, ``solve.renumber``, ``solve.unrenumber``
  and ``solve.objective``; one ``iter`` an iteration (attr ``t``; in a
  batched solve also ``lanes``, the lanes still running) holding
  ``half.W``, ``half.H`` and ``stop``; ``refresh``, the sparse quotient's
  value refresh;
- ``seam.mm``, ``seam.mtm``, ``seam.sddmm``, ``seam.wtq``, ``seam.qht``
  (``ops/matops.py``; attrs ``kind`` and ``width``);
- ``store.build`` (attr ``nnz``) with a ``store.pass`` a pass (attr
  ``pass``); ``kernels.load``, ``kernels.build``, ``native.load`` and
  ``native.build``;
- ``host_read`` (attr ``how``) around each blocking read: the host's wait
  for the card.

Nothing is recorded inside a loop over columns or over a store's entries.
Recordings do not nest; spans on other threads than the recording one are
not recorded.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["Span", "Recording", "recording", "span", "host_read", "launched",
           "NO_SPAN"]

CALL = "nnmf"  # a span of this name starts a new call id

_READS = {"bool": bool, "float": float, "tolist": lambda t: t.tolist()}


class Span:
    """One recorded span."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs", "counts")

    def __init__(self, name, parent, call, attrs):
        self.name = name
        self.parent = parent
        self.call = call
        self.attrs = attrs
        self.counts = {"host_reads": 0, "launches": 0}
        self.end_ns = None
        self.start_ns = time.time_ns()

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, parent={self.parent}, "
                f"call={self.call}, attrs={self.attrs}, counts={self.counts})")


class Recording:
    """The spans of one ``recording()`` block, in the order they opened."""

    def __init__(self):
        self.spans: list[Span] = []
        self.thread = threading.get_ident()
        self._open: list[int] = []  # indices of the open spans, innermost last
        self._calls = 0

    def innermost(self) -> Span | None:
        return self.spans[self._open[-1]] if self._open else None


_active: Recording | None = None  # the recording in progress, if any
_lock = threading.Lock()


class _NoSpan:
    """What ``span`` returns while nothing records: a context manager that
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("rec", "index")

    def __init__(self, rec, index):
        self.rec, self.index = rec, index

    def __enter__(self):
        return self.rec.spans[self.index]

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.index].end_ns = time.time_ns()
        rec._open.pop()
        return False


@contextlib.contextmanager
def recording():
    """Record the spans of the block on this thread; yields the
    ``Recording``.  Raises while another recording is on."""
    global _active
    rec = Recording()
    with _lock:
        if _active is not None:
            raise RuntimeError("a recording of spans is already on: recordings do not nest")
        _active = rec
    try:
        yield rec
    finally:
        _active = None


def span(name, **attrs):
    """``with span(name, **attrs):`` records one span while a recording is
    on, on its thread; otherwise returns ``NO_SPAN`` and records nothing."""
    rec = _active
    if rec is None:
        return NO_SPAN
    if rec.thread != threading.get_ident():
        return NO_SPAN
    parent = rec._open[-1] if rec._open else None
    if name == CALL:
        rec._calls += 1
        call = rec._calls
    else:
        call = rec.spans[parent].call if parent is not None else None
    index = len(rec.spans)
    rec.spans.append(Span(name, parent, call, attrs))
    rec._open.append(index)
    return _OpenSpan(rec, index)


def host_read(t, how):
    """``bool(t)``, ``float(t)`` or ``t.tolist()`` (``how``): the port's one
    way to read a tensor back on purpose.  While recording, the read is
    counted in the innermost span and a ``host_read`` span is recorded
    around it.  Anything but a tensor is converted and not counted."""
    read = _READS[how]
    rec = _active
    if rec is None or not isinstance(t, torch.Tensor) or rec.thread != threading.get_ident():
        return read(t)
    inner = rec.innermost()
    if inner is not None:
        inner.counts["host_reads"] += 1
    with span("host_read", how=how):
        return read(t)


def launched() -> None:
    """Count one of the port's kernel launches in the innermost span."""
    rec = _active
    if rec is None or rec.thread != threading.get_ident():
        return
    inner = rec.innermost()
    if inner is not None:
        inner.counts["launches"] += 1
