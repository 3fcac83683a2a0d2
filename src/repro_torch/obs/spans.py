"""Host spans of the port's two hot loops, kept in memory on the profiler's
clock.

A span is one named host interval of the program's own structure::

    with span("sim.dispatch", events=E) as counts:
        if counts is not None:              # recording: add counts
            counts["worker_steps"] = ...
        ...

It records a :class:`SpanRecord` (name, start and end in ``time.time_ns()``
nanoseconds, the index of the enclosing span's record or -1, and the
counts of the work done inside it) into a bounded in-memory table:
:func:`records` reads it, :func:`clear` empties it, :func:`dropped`
counts the spans the cap left out.  Nothing is written out, and nothing is
fetched from, synchronised with or allocated on the device.

Recording is on while a torch profiler runs -- it tests
``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` sets whatever its activities -- and inside
:func:`recording`.  Off, a span is that flag test and one shared no-op
context: no clock read, no record, no profiler range.  Under a profiler
each span also opens a profiler range of its name, so wherever the
profiled window records host activity the span is in the trace too.  The
range is ``torch._C._profiler._RecordFunctionFast``, a host operator:
``torch.profiler.record_function`` also puts a user annotation of the
range's name on the device timeline, where a trace reader would count it
as device time.

The clock: ``time.time_ns()`` is the Unix-epoch clock of the profiler's
raw events (``prof.profiler.kineto_results.events()[i].start_ns()``), so
spans and a trace of the same window line up without a conversion.

The spans (names are exact: readers match them):

================  ====================================================  =====================
span              where                                                 counts
================  ====================================================  =====================
``sim.run``       ``DecentralizedTrainer.run``, the whole call
``sim.events``    pulling events from the stream up to a flush          ``events``
                  (``scan``; a packed chunk's generation on
                  ``sparse_scan``)
``sim.pack``      ``EventBatch.from_events``; ``merge_event_groups``    ``events``
``sim.dispatch``  ``_dispatch_block`` / ``_dispatch_sparse_block``;     ``events``,
                  one event's step (``per_event``), one fused block     ``worker_steps``
``sim.eval``      ``_record_eval``
``sim.finish``    ``_finish``: the history's fetch, the summaries
``train.step``    ``build_train_step``'s and                            ``tokens``
                  ``build_sharded_train_step``'s ``train_step``
``train.worker``  one worker's body of the stacked step                 ``worker``, ``tokens``
``train.forward`` ``lm_loss`` in ``worker_grad_fn``                     ``attn_fused``,
                                                                        ``attn_blockwise``,
                                                                        ``attn_plain``
``train.backward`` ``torch.autograd.grad`` there
``train.sgd``     one worker's ``sgd_`` over its leaves
``train.gossip``  ``_tree_gossip``; a leaf's ``mix`` (sharded)          ``bytes`` read and
                                                                        written
================  ====================================================  =====================

``worker_steps`` counts the lanes that took a gradient; ``attn_*`` the
``lm_loss`` call's attention layers by route
(``models.layers.ATTENTION_ROUTES``: the training kernels, blockwise,
materialised), the backward's recomputation not counted; the ``per_event``
and ``fused`` paths record ``sim.run`` and ``sim.dispatch`` alone, a fused
block with ``events`` only (its lanes are drawn on the device).  The
benchmark's ``sim_event_gen_us_per_event``,
``sim_idle_outside_dispatch_pct``, ``train_grad_issue_s_per_step`` and
``train_worker_self_s_per_step`` read them; :func:`summary` gives each
name's count, total and self seconds and counts.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAP = 1 << 20           # records a table holds; later spans are dropped


class SpanRecord(NamedTuple):
    name: str
    start_ns: int           # time.time_ns() at entry
    end_ns: int             # time.time_ns() at exit
    parent: int             # index of the enclosing span's record, or -1
    counts: Dict[str, int]  # work done inside the span


class _Off:
    """The context every span shares while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class SpanTable:
    """The records of one process: a bounded list in entry order (a span's
    slot is taken at entry, so a parent's index precedes its children's;
    a span still open reads as None), the spans dropped past ``cap``, and
    the enclosing spans open on each thread."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.forced = 0         # open recording() contexts
        self.dropped = 0
        self._records: List[Optional[SpanRecord]] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def records(self) -> List[Optional[SpanRecord]]:
        return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records = []
            self.dropped = 0

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Span:
    __slots__ = ("table", "name", "counts", "records", "index", "parent",
                 "range", "start_ns")

    def __init__(self, table: SpanTable, name: str, counts: Dict[str, int]):
        self.table, self.name, self.counts = table, name, counts

    def __enter__(self) -> Dict[str, int]:
        t = self.table
        stack = t._stack()
        self.parent = stack[-1] if stack else -1
        with t._lock:
            self.records = t._records
            if len(self.records) < t.cap:
                self.index = len(self.records)
                self.records.append(None)
            else:
                self.index = -1
                t.dropped += 1
        stack.append(self.index)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start_ns = time.time_ns()
        return self.counts

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.table._stack().pop()
        # the slot is in the list the span entered, even across a clear()
        if self.index >= 0:
            self.records[self.index] = SpanRecord(
                self.name, self.start_ns, end, self.parent, self.counts)
        return False


_TABLE = SpanTable()


def span(name: str, **counts):
    """A context that records the span ``name`` with ``counts`` while
    recording is on and yields its counts dict (add to it inside), or is
    the shared no-op yielding None."""
    if not (_autograd_profiler._is_profiler_enabled or _TABLE.forced):
        return _OFF
    return _Span(_TABLE, name, counts)


def records() -> List[Optional[SpanRecord]]:
    """The process's span records in entry order."""
    return _TABLE.records()


def clear() -> None:
    """Empty the process's span table."""
    _TABLE.clear()


def dropped() -> int:
    """Spans left out of the table since it was last cleared (its cap)."""
    return _TABLE.dropped


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this context, a profiler running or not (the
    profiler range still opens only under a profiler)."""
    with _TABLE._lock:
        _TABLE.forced += 1
    try:
        yield
    finally:
        with _TABLE._lock:
            _TABLE.forced -= 1


def self_ns(recs: List[Optional[SpanRecord]]) -> List[int]:
    """Each record's self time: its duration less the part of it that its
    children's spans cover (0 for an open span's slot)."""
    covered: Dict[int, List[tuple]] = {}
    for r in recs:
        if r is not None and r.parent >= 0:
            covered.setdefault(r.parent, []).append((r.start_ns, r.end_ns))
    out = []
    for i, r in enumerate(recs):
        if r is None:
            out.append(0)
            continue
        inside, last = 0, r.start_ns
        for s, e in sorted(covered.get(i, ())):
            s, e = max(s, last), min(e, r.end_ns)
            if e > s:
                inside += e - s
                last = e
        out.append(r.end_ns - r.start_ns - inside)
    return out


def summary(recs: List[Optional[SpanRecord]], per: float = 1.0) -> List[dict]:
    """One row a span name, longest total first: ``count``, ``total_s``
    and ``self_s`` (host seconds) and the summed ``counts``, each divided
    by ``per`` (the steps or events the records cover)."""
    rows: Dict[str, dict] = {}
    for r, own in zip(recs, self_ns(recs)):
        if r is None:
            continue
        row = rows.setdefault(r.name, {"name": r.name, "count": 0,
                                       "total_s": 0.0, "self_s": 0.0,
                                       "counts": {}})
        row["count"] += 1
        row["total_s"] += (r.end_ns - r.start_ns) / 1e9
        row["self_s"] += own / 1e9
        for k, v in r.counts.items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    out = sorted(rows.values(), key=lambda row: -row["total_s"])
    for row in out:
        row["count"] /= per
        row["total_s"] /= per
        row["self_s"] /= per
        row["counts"] = {k: v / per for k, v in row["counts"].items()}
    return out
