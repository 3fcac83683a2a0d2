"""Event-driven virtual-clock schedulers for decentralized training.

Host-side copy of the reference package's scheduler module; the device
programs are bulk-synchronous, so the paper's thread-level asynchrony is realized as a *deterministic event stream*.
A scheduler simulates every worker's local-computation timeline under a
straggler model and emits, per asynchronous iteration ``k``, a
:class:`ScheduleEvent` carrying exactly the quantities of the paper's compact
update (eq. 5):

    W(k) = [W(k-1) − η · G(k-1) ⊙ mask(k)] · P(k)

The *ordering* of events — not their wall-clock overlap — determines every
worker's view of its neighbors' parameters, so parameter trajectories are
faithful to a real asynchronous cluster under the same straggler draws.

Events are **sparse-native**: a :class:`ScheduleEvent`'s primary payload is
the sorted active-worker set plus the A×A consensus submatrix restricted to
it (every scheduler keeps P identity outside the set — the invariant
tests/test_scheduler.py pins), so generating an event costs O(A²) host work
instead of the O(n²) a dense consensus matrix would. Dense views (``.P``,
``.grad_workers``, ``.restart_workers``) materialize lazily, only where a
consumer actually asks — the per-event interpreter, dense
:class:`EventBatch` packing, diagnostics.

Events are consumed one at a time (:meth:`Scheduler.events`, the legacy
interpreted path), packed into dense :class:`EventBatch` stacked arrays
that replay inside one block update, or packed into
:class:`SparseEventBatch` active-set arrays for the gather-compute-scatter
scan — the representation that makes paper-scale N=128/256 streams
affordable (a single-edge event carries a 2×2 submatrix instead of an
n×n one).  Both ``from_events`` packers are vectorized numpy batch
scatters (no per-event Python loop over ``np.ix_`` rectangles), so packing
keeps up with the sparse-native generators.  The runner packs blocks
itself via the ``from_events`` classmethods (its chunking snaps to the
eval grid and the run bounds); :meth:`Scheduler.event_batches` /
:meth:`Scheduler.sparse_event_batches` are the standalone fixed-size
packing APIs for benchmarks and diagnostics.

Staleness semantics: a worker's gradient is evaluated at the parameter
*snapshot it held when it started computing* (``restart_workers`` marks where
snapshots refresh).  For DSGD-AAU and synchronous DSGD the snapshot always
equals the current parameters; for AD-PSGD/AGP a neighbor may average into a
worker's parameters mid-computation, and the stale-gradient effect the paper
criticizes emerges naturally.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.consensus import metropolis_matrix, metropolis_submatrix
from repro_torch.core.pathsearch import PathSearchState
from repro_torch.core.topology import Graph
from repro_torch.scenarios.base import TimeModel, TimeModelSpec

Edge = Tuple[int, int]

_EMPTY_EDGES = np.zeros((0, 2), dtype=np.int32)
_EMPTY_EDGES.flags.writeable = False  # shared across events: keep it inert


class ScheduleEvent:
    """One asynchronous iteration of the compact update, in active-set form.

    Primary payload (what schedulers construct, what the sparse packer
    reads — all O(A) / O(A²), never O(n)):

    - ``workers``: (m,) int32, the *sorted* set of workers this iteration
      touches (gradient, restart, or an active edge);
    - ``P_sub``: (m, m) float, the consensus matrix restricted to that set —
      P is identity outside it by the schedulers' construction;
    - ``grad_lanes`` / ``restart_lanes``: (m,) bool, aligned with
      ``workers``;
    - ``edges``: (e, 2) int32 active-edge endpoints (global indices).

    Dense views — ``.P`` (n, n), ``.grad_workers`` / ``.restart_workers``
    (n,) bool, ``.active_edges`` tuple-of-pairs — are materialized lazily on
    first access and cached, so consumers that never ask (the sparse scan
    path, the generation benchmarks) never pay for them.  ``.P`` scatters
    ``P_sub`` into an identity matrix, which reproduces the historical dense
    build bit-exactly (see :func:`repro.core.consensus.metropolis_submatrix`
    for why the submatrices themselves are exact).
    """

    __slots__ = ("k", "time", "n", "workers", "P_sub", "grad_lanes",
                 "restart_lanes", "edges", "param_copies_sent",
                 "finish_lanes", "_P", "_gw", "_rw", "_ae")

    def __init__(self, k: int, time: float, n: int, workers: np.ndarray,
                 P_sub: np.ndarray, grad_lanes: np.ndarray,
                 restart_lanes: np.ndarray, edges: np.ndarray,
                 param_copies_sent: int,
                 dense_P: Optional[np.ndarray] = None,
                 dense_grad: Optional[np.ndarray] = None,
                 dense_restart: Optional[np.ndarray] = None,
                 finish_lanes: Optional[np.ndarray] = None):
        self.k = k
        self.time = time
        self.n = n
        self.workers = workers
        self.P_sub = P_sub
        self.grad_lanes = grad_lanes
        self.restart_lanes = restart_lanes
        self.edges = edges
        self.param_copies_sent = param_copies_sent
        # per-lane raw local-computation completion clocks, aligned with
        # ``workers`` — the event fires at ``time`` ≥ every lane's finish
        # (clique formation / averaging locks impose the wait); telemetry
        # splits busy vs idle virtual time on that gap.  None ⇒ every lane
        # finished exactly at ``time``.
        self.finish_lanes = finish_lanes
        self._P = dense_P
        self._gw = dense_grad
        self._rw = dense_restart
        self._ae = None

    @classmethod
    def from_dense(cls, k: int, time: float, grad_workers: np.ndarray,
                   restart_workers: np.ndarray, P: np.ndarray,
                   active_edges: Sequence[Edge],
                   param_copies_sent: int) -> "ScheduleEvent":
        """Build from the dense representation (custom schedulers, round
        trips).  The active set is the union of gradient workers, restarting
        workers, and active-edge endpoints; P must be identity outside it.
        The dense arrays are kept as the event's cached views, so round
        trips through this constructor are exact.
        """
        n = len(grad_workers)
        gw = np.asarray(grad_workers, dtype=bool)
        rw = np.asarray(restart_workers, dtype=bool)
        active = gw | rw
        edges = (np.asarray(active_edges, dtype=np.int32).reshape(-1, 2)
                 if len(active_edges) else _EMPTY_EDGES)
        if edges.size:
            active = active.copy()
            active[edges.ravel()] = True
        widx = np.nonzero(active)[0].astype(np.int32)
        return cls(
            k=k, time=time, n=n, workers=widx,
            P_sub=P[np.ix_(widx, widx)],
            grad_lanes=gw[widx], restart_lanes=rw[widx],
            edges=edges, param_copies_sent=param_copies_sent,
            dense_P=P, dense_grad=gw, dense_restart=rw,
        )

    # -- lazy dense views --------------------------------------------------
    @property
    def P(self) -> np.ndarray:
        """Dense (n, n) consensus matrix: identity off the active set."""
        if self._P is None:
            P = np.eye(self.n, dtype=self.P_sub.dtype
                       if self.P_sub.size else np.float64)
            if self.workers.size:
                P[np.ix_(self.workers, self.workers)] = self.P_sub
            self._P = P
        return self._P

    @property
    def grad_workers(self) -> np.ndarray:
        """Dense (n,) bool: workers whose local gradient applies."""
        if self._gw is None:
            gw = np.zeros(self.n, dtype=bool)
            gw[self.workers[self.grad_lanes]] = True
            self._gw = gw
        return self._gw

    @property
    def restart_workers(self) -> np.ndarray:
        """Dense (n,) bool: workers that re-snapshot and restart."""
        if self._rw is None:
            rw = np.zeros(self.n, dtype=bool)
            rw[self.workers[self.restart_lanes]] = True
            self._rw = rw
        return self._rw

    @property
    def active_edges(self) -> Tuple[Edge, ...]:
        if self._ae is None:
            self._ae = tuple((int(a), int(b)) for a, b in self.edges)
        return self._ae

    @property
    def n_active(self) -> int:
        return int(self.grad_lanes.sum())

    def __repr__(self) -> str:  # slots class: give diagnostics a readable form
        return (f"ScheduleEvent(k={self.k}, time={self.time:.4f}, "
                f"n={self.n}, workers={self.workers.tolist()}, "
                f"edges={self.active_edges}, "
                f"copies={self.param_copies_sent})")


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated (vectorized)."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lens)


def _pack_edges(events: Sequence["ScheduleEvent"],
                edge_bound: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Compact active-edge arrays: (E, width, 2) int32 -1-padded + counts."""
    E = len(events)
    elens = np.fromiter((len(ev.edges) for ev in events),
                        dtype=np.int64, count=E)
    width = edge_bound if edge_bound is not None else max(1, int(elens.max()))
    if elens.max(initial=0) > width:
        bad = int(np.argmax(elens))
        raise ValueError(
            f"event {events[bad].k} has {int(elens[bad])} active edges > "
            f"edge_bound {width}")
    edges = np.full((E, width, 2), -1, dtype=np.int32)
    if int(elens.sum()):
        rows = np.repeat(np.arange(E), elens)
        cols = _ragged_arange(elens)
        edges[rows, cols] = np.concatenate(
            [ev.edges for ev in events if len(ev.edges)])
    return edges, elens.astype(np.int32)


def _worker_scatter_indices(wlens: np.ndarray, flat_workers: np.ndarray):
    """Batch-scatter indices for the (E, A, A) submatrix blocks.

    Returns ``(bi, lr, lc, gr, gc)``: for every entry of every event's
    m_e×m_e submatrix (row-major), the event index, local row/col within the
    block, and the global worker indices at those lanes.
    """
    E = len(wlens)
    m2 = wlens * wlens
    bi = np.repeat(np.arange(E), m2)
    mrep = np.repeat(wlens, m2)
    within = _ragged_arange(m2)
    lr = within // np.maximum(mrep, 1)
    lc = within - lr * mrep
    starts = np.repeat(np.cumsum(wlens) - wlens, m2)
    gr = flat_workers[starts + lr]
    gc = flat_workers[starts + lc]
    return bi, lr, lc, gr, gc


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """``E`` consecutive ScheduleEvents packed into stacked arrays.

    This is the *compiled* representation of the event stream: the runner
    converts one EventBatch into device arrays and advances the whole block
    inside one block call (core/aau.py ``masked_gossip_scan``),
    instead of dispatching one jitted step per event from Python.  The dense
    ``P`` stack feeds the update; ``edges``/``n_edges`` are the compact
    active-edge form — fixed width per scheduler (``Scheduler.edge_bound``),
    ``-1``-padded — kept for diagnostics and communication accounting.
    Packing never materializes per-event dense matrices: the stack is one
    broadcast identity plus one vectorized scatter of the events' active-set
    submatrices.  For the representation that drops the dense stack
    entirely, see :class:`SparseEventBatch` (most baselines touch 1 edge out
    of O(n²) entries; the sparse form carries only the active-set
    submatrices).
    """
    k0: int                         # iteration counter of the first event
    times: np.ndarray               # (E,) float64 virtual completion clocks
    P: np.ndarray                   # (E, n, n) float32 consensus matrices
    grad_workers: np.ndarray        # (E, n) bool
    restart_workers: np.ndarray     # (E, n) bool
    param_copies_sent: np.ndarray   # (E,) int64
    edges: np.ndarray               # (E, edge_bound, 2) int32, -1-padded
    n_edges: np.ndarray             # (E,) int32 valid rows of ``edges``
    finish: Optional[np.ndarray] = None  # (E, n) float64 raw completion
    #   clocks (= times broadcast for non-active workers); None when the
    #   source events carried no finish_lanes (telemetry then treats every
    #   restart as finishing at the event clock)

    @property
    def E(self) -> int:
        return len(self.times)

    @property
    def n(self) -> int:
        return self.P.shape[1]

    @property
    def n_active(self) -> np.ndarray:
        return self.grad_workers.sum(axis=1)

    @classmethod
    def from_events(cls, events: Sequence[ScheduleEvent],
                    edge_bound: Optional[int] = None) -> "EventBatch":
        if not events:
            raise ValueError("cannot pack an empty event block")
        n = events[0].n
        E = len(events)
        edges, n_edges = _pack_edges(events, edge_bound)
        wlens = np.fromiter((len(ev.workers) for ev in events),
                            dtype=np.int64, count=E)
        flatw = (np.concatenate([ev.workers for ev in events if
                                 len(ev.workers)])
                 if int(wlens.sum()) else np.zeros(0, dtype=np.int32))
        P = np.broadcast_to(np.eye(n, dtype=np.float32), (E, n, n)).copy()
        gm = np.zeros((E, n), dtype=bool)
        rm = np.zeros((E, n), dtype=bool)
        times = np.fromiter((ev.time for ev in events),
                            dtype=np.float64, count=E)
        finish = np.repeat(times[:, None], n, axis=1)
        if flatw.size:
            bi, _, _, gr, gc = _worker_scatter_indices(wlens, flatw)
            P[bi, gr, gc] = np.concatenate(
                [ev.P_sub.ravel() for ev in events if len(ev.workers)])
            rows = np.repeat(np.arange(E), wlens)
            gm[rows, flatw] = np.concatenate(
                [ev.grad_lanes for ev in events if len(ev.workers)])
            rm[rows, flatw] = np.concatenate(
                [ev.restart_lanes for ev in events if len(ev.workers)])
            finish[rows, flatw] = np.concatenate([
                (ev.finish_lanes if ev.finish_lanes is not None
                 else np.full(len(ev.workers), ev.time))
                for ev in events if len(ev.workers)])
        return cls(
            k0=events[0].k,
            times=times,
            P=P, grad_workers=gm, restart_workers=rm,
            param_copies_sent=np.fromiter(
                (ev.param_copies_sent for ev in events),
                dtype=np.int64, count=E),
            edges=edges, n_edges=n_edges, finish=finish,
        )

    def pad_to(self, E: int) -> "EventBatch":
        """Pad with identity no-op events (P=I, empty masks) up to length E.

        A no-op event leaves ``(W, S, y)`` and the batch-pool pointers exactly
        unchanged, so the runner can always dispatch fixed-size blocks (one
        compiled program) even when an eval boundary or the end of the run
        truncates a block.
        """
        pad = E - self.E
        if pad < 0:
            raise ValueError(f"cannot pad E={self.E} down to {E}")
        if pad == 0:
            return self
        n = self.n
        eyeP = np.broadcast_to(np.eye(n, dtype=np.float32), (pad, n, n))
        off = np.zeros((pad, n), dtype=bool)
        return dataclasses.replace(
            self,
            times=np.concatenate(
                [self.times, np.full(pad, self.times[-1])]),
            P=np.concatenate([self.P, eyeP]),
            grad_workers=np.concatenate([self.grad_workers, off]),
            restart_workers=np.concatenate([self.restart_workers, off]),
            param_copies_sent=np.concatenate(
                [self.param_copies_sent, np.zeros(pad, dtype=np.int64)]),
            edges=np.concatenate([
                self.edges,
                np.full((pad,) + self.edges.shape[1:], -1, dtype=np.int32)]),
            n_edges=np.concatenate(
                [self.n_edges, np.zeros(pad, dtype=np.int32)]),
            finish=(np.concatenate(
                [self.finish, np.full((pad, n), self.times[-1])])
                if self.finish is not None else None),
        )

    def to_events(self) -> List[ScheduleEvent]:
        """Unpack back into per-event form (round-trip/diagnostic helper)."""
        out = []
        for e in range(self.E):
            m = int(self.n_edges[e])
            out.append(ScheduleEvent.from_dense(
                k=self.k0 + e, time=float(self.times[e]),
                grad_workers=self.grad_workers[e],
                restart_workers=self.restart_workers[e],
                P=self.P[e],
                active_edges=self.edges[e, :m],
                param_copies_sent=int(self.param_copies_sent[e]),
            ))
        return out


@dataclasses.dataclass(frozen=True)
class SparseEventBatch:
    """``E`` ScheduleEvents in active-set (gather-compute-scatter) form.

    The sparse sibling of :class:`EventBatch`: instead of the dense
    ``(E, n, n)`` consensus stack it carries, per event, the sorted list of
    *active workers* (every worker that fires a gradient, restarts, or sits
    on an active edge) and the ``A×A`` consensus **sub**matrix restricted to
    that set.  Every scheduler in this module keeps P identity outside the
    active set (the invariant tests/test_scheduler.py pins), so the submatrix
    plus the index list reconstruct the event exactly — at O(A²) packed
    bytes per event instead of O(n²), which is what drops the dense ``P``
    stack entirely for single-edge schedulers (A = 2 vs n = 256).  Since
    events are sparse-native, packing is a pure reshape: one vectorized
    batch scatter of the events' lanes and submatrices into the padded
    arrays, no per-event Python work.

    Lane padding: ``workers`` rows are ``-1``-padded to the scheduler's fixed
    ``active_bound`` ``A`` (stable shapes ⇒ one compiled scan for the run);
    padded lanes carry all-zero ``P_sub`` rows *and* columns and all-False
    masks, so the consumer (core/aau.py ``sparse_gossip_scan`` and the
    ``sparse_gossip`` kernel) treats them as mass-less no-ops and its
    scatter drops them.  ``grad_workers``/``restart_workers`` are per-*lane*
    bools aligned with ``workers``, not per-worker n-vectors.

    ``edges``/``n_edges`` keep the compact active-edge form of
    :class:`EventBatch` (``-1``-padded to ``edge_bound``) for diagnostics
    and communication accounting.
    """
    k0: int                         # iteration counter of the first event
    times: np.ndarray               # (E,) float64 virtual completion clocks
    workers: np.ndarray             # (E, A) int32 sorted active sets, -1-padded
    n_workers: np.ndarray           # (E,) int32 valid lanes per event
    P_sub: np.ndarray               # (E, A, A) float32 active-set submatrices
    grad_workers: np.ndarray        # (E, A) bool, per-lane
    restart_workers: np.ndarray     # (E, A) bool, per-lane
    param_copies_sent: np.ndarray   # (E,) int64
    edges: np.ndarray               # (E, edge_bound, 2) int32, -1-padded
    n_edges: np.ndarray             # (E,) int32 valid rows of ``edges``
    finish: Optional[np.ndarray] = None  # (E, A) float64 per-lane raw
    #   completion clocks (= times broadcast on pad lanes); None when the
    #   source events carried no finish_lanes

    @property
    def E(self) -> int:
        return len(self.times)

    @property
    def A(self) -> int:
        return self.workers.shape[1]

    @property
    def n_active(self) -> np.ndarray:
        return self.grad_workers.sum(axis=1)

    @classmethod
    def from_events(cls, events: Sequence[ScheduleEvent], active_bound: int,
                    edge_bound: Optional[int] = None) -> "SparseEventBatch":
        if not events:
            raise ValueError("cannot pack an empty event block")
        A = max(1, active_bound)
        E = len(events)
        wlens = np.fromiter((len(ev.workers) for ev in events),
                            dtype=np.int64, count=E)
        if wlens.max(initial=0) > A:
            bad = int(np.argmax(wlens))
            raise ValueError(
                f"event {events[bad].k} touches {int(wlens[bad])} workers > "
                f"active_bound {A}")
        workers = np.full((E, A), -1, dtype=np.int32)
        P_sub = np.zeros((E, A, A), dtype=np.float32)
        gm = np.zeros((E, A), dtype=bool)
        rm = np.zeros((E, A), dtype=bool)
        times = np.fromiter((ev.time for ev in events),
                            dtype=np.float64, count=E)
        finish = np.repeat(times[:, None], A, axis=1)
        if int(wlens.sum()):
            nonempty = [ev for ev in events if len(ev.workers)]
            flatw = np.concatenate([ev.workers for ev in nonempty])
            rows = np.repeat(np.arange(E), wlens)
            cols = _ragged_arange(wlens)
            workers[rows, cols] = flatw
            gm[rows, cols] = np.concatenate(
                [ev.grad_lanes for ev in nonempty])
            rm[rows, cols] = np.concatenate(
                [ev.restart_lanes for ev in nonempty])
            finish[rows, cols] = np.concatenate([
                (ev.finish_lanes if ev.finish_lanes is not None
                 else np.full(len(ev.workers), ev.time))
                for ev in nonempty])
            bi, lr, lc, _, _ = _worker_scatter_indices(wlens, flatw)
            P_sub[bi, lr, lc] = np.concatenate(
                [ev.P_sub.ravel() for ev in nonempty])
        edges, n_edges = _pack_edges(events, edge_bound)
        return cls(
            k0=events[0].k,
            times=times,
            workers=workers, n_workers=wlens.astype(np.int32), P_sub=P_sub,
            grad_workers=gm, restart_workers=rm,
            param_copies_sent=np.fromiter(
                (ev.param_copies_sent for ev in events),
                dtype=np.int64, count=E),
            edges=edges, n_edges=n_edges, finish=finish,
        )

    def pad_to(self, E: int) -> "SparseEventBatch":
        """Pad with no-op events (empty active sets) up to length E.

        An empty active set gathers nothing and scatters nothing, so the
        scan carry ``(W, S, y, ptr)`` passes through bit-exact — the sparse
        analogue of :meth:`EventBatch.pad_to`'s identity events.
        """
        pad = E - self.E
        if pad < 0:
            raise ValueError(f"cannot pad E={self.E} down to {E}")
        if pad == 0:
            return self
        A = self.A
        off = np.zeros((pad, A), dtype=bool)
        return dataclasses.replace(
            self,
            times=np.concatenate([self.times, np.full(pad, self.times[-1])]),
            workers=np.concatenate(
                [self.workers, np.full((pad, A), -1, dtype=np.int32)]),
            n_workers=np.concatenate(
                [self.n_workers, np.zeros(pad, dtype=np.int32)]),
            P_sub=np.concatenate(
                [self.P_sub, np.zeros((pad, A, A), dtype=np.float32)]),
            grad_workers=np.concatenate([self.grad_workers, off]),
            restart_workers=np.concatenate([self.restart_workers, off]),
            param_copies_sent=np.concatenate(
                [self.param_copies_sent, np.zeros(pad, dtype=np.int64)]),
            edges=np.concatenate([
                self.edges,
                np.full((pad,) + self.edges.shape[1:], -1, dtype=np.int32)]),
            n_edges=np.concatenate(
                [self.n_edges, np.zeros(pad, dtype=np.int32)]),
            finish=(np.concatenate(
                [self.finish, np.full((pad, A), self.times[-1])])
                if self.finish is not None else None),
        )

    def slice(self, start: int, stop: int) -> "SparseEventBatch":
        """Contiguous event range ``[start, stop)`` as its own batch.

        Pure numpy views (no copies) — the bucketed dispatcher carves each
        same-bucket stream segment out of its bucket's packed arrays with
        this.  ``k0`` shifts with ``start``, which is only meaningful when
        the batch's own events are k-consecutive (bucket batches are not;
        :class:`BucketedSparseEventBatch` restores stream ``k`` itself).
        """
        if not (0 <= start < stop <= self.E):
            raise ValueError(f"bad slice [{start}, {stop}) of E={self.E}")
        return dataclasses.replace(
            self, k0=self.k0 + start,
            times=self.times[start:stop],
            workers=self.workers[start:stop],
            n_workers=self.n_workers[start:stop],
            P_sub=self.P_sub[start:stop],
            grad_workers=self.grad_workers[start:stop],
            restart_workers=self.restart_workers[start:stop],
            param_copies_sent=self.param_copies_sent[start:stop],
            edges=self.edges[start:stop],
            n_edges=self.n_edges[start:stop],
            finish=(self.finish[start:stop]
                    if self.finish is not None else None),
        )

    def head(self, j: int) -> "SparseEventBatch":
        """The first ``j`` events (no-op when ``j >= E``).

        The packed-stream consumer truncates a chunk here when ``max_time``
        lands inside it — the array analogue of the per-event loop's
        ``ev.time > max_time`` break.
        """
        if j >= self.E:
            return self
        return self.slice(0, j)

    # -- stream-order metadata (uniform with BucketedSparseEventBatch) ----
    def stream_times(self) -> np.ndarray:
        return self.times

    def stream_copies(self) -> np.ndarray:
        return self.param_copies_sent

    def stream_n_active(self) -> np.ndarray:
        return self.n_active

    def to_events(self, n: int) -> List[ScheduleEvent]:
        """Reconstruct per-event form (round-trip/diagnostic helper).

        The returned events are sparse-native views of the packed lanes;
        their dense ``.P`` (an identity with the float32 submatrix scattered
        in) materializes lazily like any other event's.
        """
        out = []
        for e in range(self.E):
            m = int(self.n_workers[e])
            me = int(self.n_edges[e])
            out.append(ScheduleEvent(
                k=self.k0 + e, time=float(self.times[e]), n=n,
                workers=self.workers[e, :m],
                P_sub=self.P_sub[e, :m, :m],
                grad_lanes=self.grad_workers[e, :m],
                restart_lanes=self.restart_workers[e, :m],
                edges=self.edges[e, :me],
                param_copies_sent=int(self.param_copies_sent[e]),
                finish_lanes=(self.finish[e, :m]
                              if self.finish is not None else None),
            ))
        return out


def merge_event_groups(batch: SparseEventBatch,
                       K: int) -> Tuple[SparseEventBatch, np.ndarray]:
    """Merge runs of conflict-free events into compact K·A-lane rows.

    The packing half of the event-blocked scan (the reference measured
    ~100 µs of per-scan-step overhead *independent of N* — the dominant
    sparse-path cost for narrow lanes): consecutive events whose active
    sets are pairwise disjoint commute as state updates (each touches only
    its own ``(W, S, y, ptr)`` rows and gathers only rows the others never
    write), so a run of them is replayed *exactly* by one K·A-lane "event"
    whose ``P_sub`` is the block-diagonal stack of the members' submatrices
    and whose lanes are their concatenation.  The existing
    ``sparse_gossip_scan`` body consumes the merged row unchanged — the
    gather, the masked einsum (zero cross-blocks contribute exact zeros in
    order, so partial sums are bit-identical), and the unique-index scatter
    are all oblivious to the grouping — which amortizes the thunk overhead
    group-size-fold while keeping the replay bit-exact against the
    per-event dispatch.

    Packing is *compact*: each member contributes only its ``n_workers``
    valid lanes (its pad lanes are dropped), so a group holds as many
    events as fit in the K·A lane budget — for low-fill streams (DSGD-AAU
    rungs pack ~30% of their lanes) that is ~3× more events per scan step
    than block-slot placement at the same per-step lane cost.  Grouping is
    greedy in stream order and breaks at the first conflict or full budget,
    so order of application never matters within a group.  Returns the
    merged batch of lane width ``K·A`` plus ``lane_off``: (G, K·A) int32
    mapping every merged lane to its source event's offset within ``batch``
    (for per-lane η decay); pad lanes map to offset 0 — their masks are
    False, so their η is never applied.

    Merged rows are an *execution* form only: lanes are not globally
    sorted and ``times``/``k0`` keep whole-group granularity (``times`` =
    last member's clock, ``param_copies_sent`` = the group's sum) —
    round-trip via ``to_events`` is not supported.
    """
    E, A = batch.E, batch.A
    if K <= 1:
        off = np.broadcast_to(np.arange(E, dtype=np.int32)[:, None], (E, A))
        return batch, off
    AK = A * K
    groups: List[Tuple[int, int]] = []      # (start, count)
    start, count, lanes = 0, 0, 0
    used: set = set()
    for e in range(E):
        m = int(batch.n_workers[e])
        ws = batch.workers[e, :m].tolist()
        if count and (lanes + m > AK or not used.isdisjoint(ws)):
            groups.append((start, count))
            start, count, lanes = e, 0, 0
            used.clear()
        used.update(ws)
        count += 1
        lanes += m
    groups.append((start, count))
    G = len(groups)
    ew_m = max(1, int(max(batch.n_edges[s:s + c].sum()
                          for s, c in groups)))
    workers = np.full((G, AK), -1, dtype=np.int32)
    P_sub = np.zeros((G, AK, AK), dtype=np.float32)
    gm = np.zeros((G, AK), dtype=bool)
    rm = np.zeros((G, AK), dtype=bool)
    lane_off = np.zeros((G, AK), dtype=np.int32)
    edges = np.full((G, ew_m, 2), -1, dtype=np.int32)
    n_edges = np.zeros(G, dtype=np.int32)
    times = np.empty(G, dtype=np.float64)
    finish = np.zeros((G, AK), dtype=np.float64)
    copies = np.zeros(G, dtype=np.int64)
    for gi, (s, c) in enumerate(groups):
        o = 0
        for j in range(c):
            m = int(batch.n_workers[s + j])
            workers[gi, o:o + m] = batch.workers[s + j, :m]
            P_sub[gi, o:o + m, o:o + m] = batch.P_sub[s + j, :m, :m]
            gm[gi, o:o + m] = batch.grad_workers[s + j, :m]
            rm[gi, o:o + m] = batch.restart_workers[s + j, :m]
            finish[gi, o:o + m] = (batch.finish[s + j, :m]
                                   if batch.finish is not None
                                   else batch.times[s + j])
            lane_off[gi, o:o + m] = s + j
            o += m
            ne = int(batch.n_edges[s + j])
            if ne:
                e0 = int(n_edges[gi])
                edges[gi, e0:e0 + ne] = batch.edges[s + j, :ne]
                n_edges[gi] += ne
        times[gi] = batch.times[s + c - 1]
        copies[gi] = int(batch.param_copies_sent[s:s + c].sum())
    merged = SparseEventBatch(
        k0=batch.k0, times=times, workers=workers,
        n_workers=(workers >= 0).sum(axis=1).astype(np.int32),
        P_sub=P_sub, grad_workers=gm, restart_workers=rm,
        param_copies_sent=copies, edges=edges, n_edges=n_edges,
        finish=finish)
    return merged, lane_off


def geometric_buckets(n: int, base: int = 16, ratio: int = 4) -> Tuple[int, ...]:
    """Ascending lane-width ladder ``(base, base·ratio, …, n)`` capped at n.

    The bucketing granularity for schedulers whose per-event active-set
    size is a *distribution* rather than a constant (DSGD-AAU).  The ladder
    is deliberately coarse: measured AAU streams at N=256 put ~90% of
    events at ≤16 workers with a heavy tail up to ~n, and a fine (pow2)
    ladder fragments the stream into single-event bucket runs — with
    ratio 4 starting at 16, consecutive events almost always share a
    bucket, so the runner dispatches long homogeneous chunks.  The last
    rung is always exactly ``n``: the dense-fallback bucket that absorbs
    the rare epoch-boundary barrier events.
    """
    if n <= base:
        return (max(1, n),)
    ladder = []
    w = base
    while w < n:
        ladder.append(w)
        w *= ratio
    ladder.append(n)
    return tuple(ladder)


def bucket_index(buckets: Sequence[int], size: int) -> int:
    """Smallest bucket whose lane width fits ``size`` active workers."""
    for b, width in enumerate(buckets):
        if size <= width:
            return b
    raise ValueError(
        f"active-set size {size} exceeds the widest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class BucketedSparseEventBatch:
    """``E`` ScheduleEvents partitioned into lane-width buckets.

    The bucketed sibling of :class:`SparseEventBatch`: instead of padding
    every event to one scheduler-wide ``active_bound`` (for DSGD-AAU that
    is A = n — the whole sparse path degenerates to dense padding), events
    are grouped by active-set size into a small ladder of lane widths
    (:meth:`Scheduler.active_buckets`) and packed once per bucket.  Each
    bucket holds its events *in stream order*; ``event_bucket`` /
    ``positions`` record, for every stream position, which bucket the event
    went to and where it sits inside that bucket's packed arrays, so the
    original order is always reconstructible (:meth:`to_events`).

    Execution stays order-exact: state updates are sequential, so the
    consumer never replays a whole bucket at once — :meth:`segments` yields
    the stream's maximal runs of same-bucket events (contiguous both in the
    stream and inside their bucket's arrays), and the runner dispatches
    those runs in order, each through the compiled program of its bucket's
    lane width.  ``-1``-padded lanes inside a bucket keep the
    :class:`SparseEventBatch` no-op semantics, so a size-5 event in the
    A=16 bucket is exact, just 11 lanes lighter than the old A=n padding.
    """
    k0: int                                  # iteration counter of stream pos 0
    buckets: Tuple[int, ...]                 # ascending lane widths
    batches: Tuple[Optional[SparseEventBatch], ...]  # one per bucket (None: empty)
    event_bucket: np.ndarray                 # (E,) int32 bucket index per stream pos
    positions: np.ndarray                    # (E,) int32 row within the bucket batch

    @property
    def E(self) -> int:
        return len(self.event_bucket)

    @classmethod
    def from_events(cls, events: Sequence[ScheduleEvent],
                    buckets: Sequence[int],
                    edge_bound: Optional[int] = None
                    ) -> "BucketedSparseEventBatch":
        if not events:
            raise ValueError("cannot pack an empty event block")
        buckets = tuple(buckets)
        if list(buckets) != sorted(set(buckets)):
            raise ValueError(f"buckets must be ascending and unique: {buckets}")
        eb = np.fromiter(
            (bucket_index(buckets, len(ev.workers)) for ev in events),
            dtype=np.int32, count=len(events))
        positions = np.zeros(len(events), dtype=np.int32)
        per_bucket: List[List[ScheduleEvent]] = [[] for _ in buckets]
        for i, ev in enumerate(events):
            b = int(eb[i])
            positions[i] = len(per_bucket[b])
            per_bucket[b].append(ev)
        batches = tuple(
            SparseEventBatch.from_events(
                evs, active_bound=buckets[b],
                # a bucket of A-worker events carries at most the A-clique's
                # edges — no reason to pad its edge arrays to the graph width
                edge_bound=min(edge_bound,
                               max(1, buckets[b] * (buckets[b] - 1) // 2))
                if edge_bound is not None else None)
            if evs else None
            for b, evs in enumerate(per_bucket))
        return cls(k0=events[0].k, buckets=buckets, batches=batches,
                   event_bucket=eb, positions=positions)

    def segments(self) -> Iterator[Tuple[int, int, int]]:
        """Maximal same-bucket runs, in stream order.

        Yields ``(bucket, start, stop)``: stream positions ``[start, stop)``
        all live in ``bucket``, and (because stream order is preserved
        within each bucket) they occupy the *contiguous* row range
        ``[positions[start], positions[start] + stop - start)`` of
        ``batches[bucket]``.
        """
        eb = self.event_bucket
        start = 0
        for i in range(1, len(eb)):
            if eb[i] != eb[start]:
                yield int(eb[start]), start, i
                start = i
        yield int(eb[start]), start, len(eb)

    def segment_batches(self) -> Iterator[Tuple[int, int, SparseEventBatch]]:
        """(bucket, stream_start, packed slice) per segment, in stream order."""
        for b, start, stop in self.segments():
            p0 = int(self.positions[start])
            yield b, start, self.batches[b].slice(p0, p0 + (stop - start))

    def head(self, j: int) -> "BucketedSparseEventBatch":
        """The first ``j`` stream positions (no-op when ``j >= E``).

        Each bucket keeps exactly its events among the first ``j`` — stream
        order is preserved within buckets, so that is a prefix of every
        bucket's packed rows.  Used by the packed-stream consumer to
        truncate a chunk at a ``max_time`` crossing.
        """
        if j >= self.E:
            return self
        eb = self.event_bucket[:j]
        counts = np.bincount(eb, minlength=len(self.buckets))
        batches = tuple(
            batch.slice(0, int(c)) if (batch is not None and c) else None
            for batch, c in zip(self.batches, counts))
        return dataclasses.replace(self, batches=batches, event_bucket=eb,
                                   positions=self.positions[:j])

    def _stream_gather(self, field: str, dtype) -> np.ndarray:
        out = np.zeros(self.E, dtype=dtype)
        for b, batch in enumerate(self.batches):
            if batch is None:
                continue
            mask = self.event_bucket == b
            out[mask] = getattr(batch, field)[self.positions[mask]]
        return out

    def stream_times(self) -> np.ndarray:
        """Per-event virtual clocks in stream order."""
        return self._stream_gather("times", np.float64)

    def stream_copies(self) -> np.ndarray:
        """Per-event parameter copies sent, in stream order."""
        return self._stream_gather("param_copies_sent", np.int64)

    def stream_n_active(self) -> np.ndarray:
        """Per-event active-gradient counts, in stream order."""
        out = np.zeros(self.E, dtype=np.int64)
        for b, batch in enumerate(self.batches):
            if batch is None:
                continue
            mask = self.event_bucket == b
            out[mask] = batch.n_active[self.positions[mask]]
        return out

    def to_events(self, n: int) -> List[ScheduleEvent]:
        """Reconstruct the stream-ordered per-event form."""
        unpacked = [batch.to_events(n) if batch is not None else []
                    for batch in self.batches]
        out = []
        for i, (b, p) in enumerate(zip(self.event_bucket, self.positions)):
            ev = unpacked[int(b)][int(p)]
            ev.k = self.k0 + i      # bucket-local k0+pos → stream counter
            out.append(ev)
        return out

    def occupancy(self) -> List[Dict[str, float]]:
        """Per-bucket packing stats: how full the lanes actually are.

        ``lane_fill`` is Σ active workers / (events · A) for the bucket —
        the padding-waste measure the static ``active_bound`` hid (the old
        single-bound packing of a DSGD-AAU stream at N=256 sat under 4%
        fill).  ``events`` counts the bucket's stream share.
        """
        out = []
        for b, batch in enumerate(self.batches):
            if batch is None:
                out.append({"A": int(self.buckets[b]), "events": 0,
                            "lane_fill": 0.0})
                continue
            fill = float(batch.n_workers.sum()) / (batch.E * batch.A)
            out.append({"A": int(self.buckets[b]), "events": int(batch.E),
                        "lane_fill": fill})
        return out


class PackedEventStream:
    """Pull-based packed-chunk view of a scheduler's event stream.

    The consumption protocol of the runner's sparse path: ``next_chunk(k)``
    returns the next ``k`` events already packed — a
    :class:`SparseEventBatch` for single-rung schedulers, a
    :class:`BucketedSparseEventBatch` for multi-rung ladders — or a shorter
    final chunk / ``None`` when a finite stream ends.  This base adapter
    wraps any scheduler's ``events()`` iterator and packs with the
    ``from_events`` classmethods, so every scheduler conforms; schedulers
    with a *native* generator (``Scheduler._native_packed_stream``) fill the
    packed arrays directly inside their event loop and skip the per-event
    ``ScheduleEvent`` objects entirely.
    """

    def __init__(self, scheduler: "Scheduler"):
        self.scheduler = scheduler
        self.buckets = scheduler.active_buckets()
        self._ebound = scheduler.edge_bound()
        self._iter = scheduler.events()

    @property
    def bucketed(self) -> bool:
        return len(self.buckets) > 1

    def next_chunk(self, k: int):
        buf = []
        for ev in self._iter:
            buf.append(ev)
            if len(buf) == k:
                break
        if not buf:
            return None
        if self.bucketed:
            return BucketedSparseEventBatch.from_events(
                buf, buckets=self.buckets, edge_bound=self._ebound)
        return SparseEventBatch.from_events(
            buf, active_bound=self.buckets[-1], edge_bound=self._ebound)


class CliquePackedStream(PackedEventStream):
    """Array-native packing for clique-event schedulers (AAU/Prague/sync).

    Consumes a *tuple* generator — ``(t, workers, P_sub, edges, copies)``
    per event, every lane grad+restart active (the shape all clique
    schedulers share) — and fills the packed chunk arrays directly: the
    per-event ``ScheduleEvent`` object, its lane masks, and the
    ``from_events`` re-scatter all disappear from the generation hot loop.
    The produced chunks are bit-identical to the object path's (same float
    casts, same ``k0``/edge-width conventions), which the round-trip tests
    pin.
    """

    def __init__(self, scheduler: "Scheduler", tuples: Iterator[tuple]):
        self.scheduler = scheduler
        self.buckets = scheduler.active_buckets()
        self._ebound = scheduler.edge_bound()
        self._tuples = tuples
        self._k = 0

    def next_chunk(self, k: int):
        buf = []
        for tup in self._tuples:
            buf.append(tup)
            if len(buf) == k:
                break
        if not buf:
            return None
        chunk = (self._pack_bucketed(buf) if self.bucketed
                 else self._pack_flat(buf))
        self._k += len(buf)
        return chunk

    @staticmethod
    def _alloc(E: int, A: int, ew: int):
        return dict(
            workers=np.full((E, A), -1, dtype=np.int32),
            n_workers=np.zeros(E, dtype=np.int32),
            P_sub=np.zeros((E, A, A), dtype=np.float32),
            grad_workers=np.zeros((E, A), dtype=bool),
            restart_workers=np.zeros((E, A), dtype=bool),
            edges=np.full((E, ew, 2), -1, dtype=np.int32),
            n_edges=np.zeros(E, dtype=np.int32),
            times=np.empty(E, dtype=np.float64),
            param_copies_sent=np.zeros(E, dtype=np.int64),
            finish=np.zeros((E, A), dtype=np.float64),
        )

    @staticmethod
    def _fill(a: dict, row: int, t, widx, P_sub, edges, copies,
              finish=None) -> None:
        m = len(widx)
        a["workers"][row, :m] = widx
        a["n_workers"][row] = m
        a["P_sub"][row, :m, :m] = P_sub
        a["grad_workers"][row, :m] = True
        a["restart_workers"][row, :m] = True
        e = len(edges)
        if e:
            a["edges"][row, :e] = edges
        a["n_edges"][row] = e
        a["times"][row] = t
        a["param_copies_sent"][row] = copies
        a["finish"][row] = t            # pad lanes read the event clock
        if finish is not None:
            a["finish"][row, :m] = finish

    def _pack_flat(self, buf) -> SparseEventBatch:
        a = self._alloc(len(buf), self.buckets[-1], self._ebound)
        for row, tup in enumerate(buf):
            self._fill(a, row, *tup)
        return SparseEventBatch(k0=self._k, **a)

    def _pack_bucketed(self, buf) -> BucketedSparseEventBatch:
        buckets = self.buckets
        E = len(buf)
        eb = np.empty(E, dtype=np.int32)
        pos = np.empty(E, dtype=np.int32)
        counts = [0] * len(buckets)
        for j, tup in enumerate(buf):
            b = bucket_index(buckets, len(tup[1]))
            eb[j] = b
            pos[j] = counts[b]
            counts[b] += 1
        allocs = [
            self._alloc(c, A, min(self._ebound, max(1, A * (A - 1) // 2)))
            if c else None for c, A in zip(counts, buckets)]
        k0s = [None] * len(buckets)
        for j, tup in enumerate(buf):
            b = int(eb[j])
            if k0s[b] is None:
                k0s[b] = self._k + j
            self._fill(allocs[b], int(pos[j]), *tup)
        batches = tuple(
            SparseEventBatch(k0=k0s[b], **a) if a is not None else None
            for b, a in enumerate(allocs))
        return BucketedSparseEventBatch(k0=self._k, buckets=buckets,
                                        batches=batches, event_bucket=eb,
                                        positions=pos)


class Scheduler:
    """Base: iterate ScheduleEvents forever (caller bounds by count/time)."""

    name = "base"

    #: True when *every* event touches all n workers (barrier algorithms
    #: like synchronous DSGD).  The sparse gather-compute-scatter path is
    #: pure overhead for such streams, so the runner's ``mode="sparse_scan"``
    #: automatically falls back to the dense scan.
    global_events = False

    def __init__(self, graph: Graph, straggler: TimeModelSpec):
        # ``straggler`` is anything satisfying the TimeModelSpec protocol:
        # the paper's StragglerModel or any registered Scenario
        # (repro/scenarios) — schedulers only ever touch the sampler's
        # TimeModel surface (sample / sample_batch / sample_horizon /
        # sample_all / base).
        if straggler.n != graph.n:
            raise ValueError("time model and graph disagree on n")
        self.graph = graph
        self.n = graph.n
        self.sampler: TimeModel = straggler.make_sampler()

    def events(self) -> Iterator[ScheduleEvent]:
        raise NotImplementedError

    def edge_bound(self) -> int:
        """Max #active edges any single event of this scheduler can carry.

        Fixed per scheduler so every EventBatch has the same compact-edge
        width (stable shapes ⇒ no recompilation across blocks).  Subclasses
        with tighter structure (pairwise gossip, bounded groups) override.
        """
        return max(1, len(self.graph.edges))

    def active_bound(self) -> int:
        """Max #workers any single event touches (grad, restart, or edge).

        This is the fixed lane width ``A`` of :class:`SparseEventBatch` —
        the per-event cost of the sparse scan path is O(A·D) gradients plus
        O(A²·D) mixing, so tight subclass overrides (AD-PSGD/AGP: 2,
        Prague: group size) are what turn O(n²·D) events into O(D) ones.
        """
        return self.n

    def active_buckets(self) -> Tuple[int, ...]:
        """Ascending lane-width ladder this scheduler's events pack into.

        The generalization of :meth:`active_bound` from a scalar to a
        distribution: schedulers whose events all share one size keep the
        degenerate single-bucket default (AD-PSGD/AGP always ``(2,)``,
        Prague ``(group_size,)``, the sync barrier ``(n,)``) and the runner
        compiles exactly the programs it always did.  Schedulers whose
        active-set size *varies* per event (DSGD-AAU: clique sizes from 2 up
        to n at epoch barriers) override with a multi-rung ladder so the
        common small events stop paying the worst case's padding.  The last
        rung must equal :meth:`active_bound` — it is the dense fallback that
        makes every event packable.
        """
        return (self.active_bound(),)

    def _native_packed_stream(self) -> Optional[PackedEventStream]:
        """Native packed-generation fast path, or None to use the adapter.

        Subclasses with a generator that fills ``SparseEventBatch`` /
        ``BucketedSparseEventBatch`` arrays directly (no intermediate
        ``ScheduleEvent`` objects) return their stream here.  The packed
        arrays must be *bit-identical* to the adapter path's — same RNG
        consumption order, same float casts — which
        tests/test_fused_stream.py pins chunk-by-chunk for every scheduler.
        """
        return None

    def packed_stream(self, native: bool = True) -> PackedEventStream:
        """The event stream in packed-chunk (``next_chunk``) form.

        ``native=True`` (default) uses the scheduler's array-native
        generator when it has one; ``native=False`` forces the
        object-path adapter (equivalence tests, custom ``events()``
        overrides).
        """
        if native:
            stream = self._native_packed_stream()
            if stream is not None:
                return stream
        return PackedEventStream(self)

    def event_batches(self, block_size: int) -> Iterator[EventBatch]:
        """Pack consecutive events into EventBatches of ``block_size``.

        A finite event stream ends with one trailing partial batch (the
        built-in schedulers stream forever, but subclasses may not).
        """
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        bound = self.edge_bound()
        buf: List[ScheduleEvent] = []
        for ev in self.events():
            buf.append(ev)
            if len(buf) == block_size:
                yield EventBatch.from_events(buf, edge_bound=bound)
                buf = []
        if buf:
            yield EventBatch.from_events(buf, edge_bound=bound)

    def sparse_event_batches(self, block_size: int,
                             native: bool = True) -> Iterator[SparseEventBatch]:
        """Pack consecutive events into active-set SparseEventBatches.

        With ``native=True`` (default) single-rung schedulers that carry an
        array-native generator fill the packed arrays directly — no
        per-event ``ScheduleEvent`` objects — producing bit-identical
        batches to the object path (``native=False``).
        """
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if native and len(self.active_buckets()) == 1:
            stream = self._native_packed_stream()
            if stream is not None and not stream.bucketed:
                while True:
                    chunk = stream.next_chunk(block_size)
                    if chunk is None:
                        return
                    yield chunk
                    if chunk.E < block_size:
                        return
        abound = self.active_bound()
        ebound = self.edge_bound()
        buf: List[ScheduleEvent] = []
        for ev in self.events():
            buf.append(ev)
            if len(buf) == block_size:
                yield SparseEventBatch.from_events(
                    buf, active_bound=abound, edge_bound=ebound)
                buf = []
        if buf:
            yield SparseEventBatch.from_events(
                buf, active_bound=abound, edge_bound=ebound)

    def bucketed_sparse_event_batches(
            self, block_size: int,
            native: bool = True) -> Iterator[BucketedSparseEventBatch]:
        """Pack consecutive events into bucketed lane-width batches.

        ``native=True`` (default) takes the scheduler's array-native
        generator when it produces bucketed chunks (multi-rung ladders).
        """
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if native and len(self.active_buckets()) > 1:
            stream = self._native_packed_stream()
            if stream is not None and stream.bucketed:
                while True:
                    chunk = stream.next_chunk(block_size)
                    if chunk is None:
                        return
                    yield chunk
                    if chunk.E < block_size:
                        return
        buckets = self.active_buckets()
        ebound = self.edge_bound()
        buf: List[ScheduleEvent] = []
        for ev in self.events():
            buf.append(ev)
            if len(buf) == block_size:
                yield BucketedSparseEventBatch.from_events(
                    buf, buckets=buckets, edge_bound=ebound)
                buf = []
        if buf:
            yield BucketedSparseEventBatch.from_events(
                buf, buckets=buckets, edge_bound=ebound)

    # -- shared helpers ---------------------------------------------------
    def _mask(self, workers) -> np.ndarray:
        m = np.zeros(self.n, dtype=bool)
        m[list(workers)] = True
        return m


class AAUScheduler(Scheduler):
    """DSGD-AAU (paper Algorithms 1–3).

    All workers compute local gradients at their own pace.  An iteration ends
    when the set of currently-finished workers contains at least one
    Pathsearch-committable edge; every finished worker then gossip-averages
    with its finished graph-neighbors using Metropolis weights, applies its
    gradient, and restarts.  Stragglers simply keep computing across
    iterations — nobody stalls on them, yet Pathsearch guarantees their
    information joins the spanning structure at least once per epoch.
    """

    name = "dsgd_aau"

    def __init__(self, graph: Graph, straggler: TimeModelSpec,
                 buckets: Optional[Sequence[int]] = None):
        super().__init__(graph, straggler)
        if buckets is not None:
            buckets = tuple(buckets)
            if not buckets or buckets[-1] != self.n:
                raise ValueError(
                    f"AAU buckets must end at n={self.n} (the dense "
                    f"fallback for epoch-boundary barriers): {buckets}")
        self._buckets = buckets

    def active_buckets(self) -> Tuple[int, ...]:
        """Coarse geometric ladder over the finished-clique size distribution.

        AAU's event sizes are heavy-tailed — measured streams at N=256 put
        the median finished clique at ~5 workers and p90 at ~13, with a thin
        tail reaching n at Pathsearch epoch boundaries — so a static
        ``active_bound()`` lane width of n pads the typical event ~30×.
        :func:`geometric_buckets`' defaults (start 16, ratio 4) were chosen
        against that measurement: ≳90% of events land in the first rung and
        consecutive events almost always share a bucket, keeping the
        runner's same-bucket dispatch segments long.  ``buckets=`` at
        construction overrides the ladder (tests force fine ladders to
        exercise multi-bucket streams at small n).
        """
        return self._buckets if self._buckets is not None \
            else geometric_buckets(self.n)

    def _clique_tuples(self) -> Iterator[tuple]:
        """The AAU event process as packed-ready tuples.

        Single source of truth for the simulation loop: yields
        ``(t, workers, P_sub, edges, copies, finish)`` per event —
        ``finish`` the per-lane raw completion clocks (clique members wait
        for the newest finisher, so ``finish ≤ t`` lane-wise);
        :meth:`events` wraps each into a :class:`ScheduleEvent` for the
        legacy paths and :meth:`_native_packed_stream` feeds them straight
        into :class:`CliquePackedStream` array fills.
        """
        n = self.n
        adj = self.graph.adj
        ps = PathSearchState(self.graph)
        sample_batch = self.sampler.sample_batch
        heap: List[Tuple[float, int]] = []
        for i, dt in enumerate(sample_batch(np.arange(n))):
            heapq.heappush(heap, (dt, i))
        finished = np.zeros(n, dtype=bool)
        finish_at = np.zeros(n, dtype=np.float64)
        while True:
            t, i = heapq.heappop(heap)
            finished[i] = True
            finish_at[i] = t
            if n > 1:
                # One O(deg) neighborhood scan per worker finish instead of
                # an O(|finished|²) rescan: between commits the component
                # partition is frozen and earlier finishes found nothing, so
                # the committable set is exactly the edges incident to the
                # newest finisher (PathSearchState.novel_edges_incident).
                novel = ps.novel_edges_incident(i, finished)
                if not novel:
                    continue
                ps.commit(novel)
            # degenerate single-worker case (n == 1): every finish fires
            # All finished workers exchange with their finished graph-neighbors:
            # the event is the finished clique's Metropolis mixing, built as an
            # m×m submatrix — the dense (n, n) matrix never exists here.
            fin = np.flatnonzero(finished)
            widx = fin.astype(np.int32)
            sub_adj = adj[np.ix_(widx, widx)]
            er, ec = np.nonzero(np.triu(sub_adj, k=1))
            edges = np.stack([widx[er], widx[ec]], axis=1) if er.size \
                else _EMPTY_EDGES
            yield (t, widx, metropolis_submatrix(n, widx, sub_adj),
                   edges, 2 * len(edges), finish_at[widx].copy())
            # batch-draw the restarted workers' next completion times: one
            # vectorized RNG call instead of one heap-push-sized draw each
            fl = fin.tolist()
            for j, dt in zip(fl, sample_batch(fl)):
                heapq.heappush(heap, (t + dt, j))
            finished[:] = False
            if n > 1 and ps.epoch_complete():
                ps.reset_epoch()

    def events(self) -> Iterator[ScheduleEvent]:
        n = self.n
        for k, (t, widx, P_sub, edges, copies, fin) in \
                enumerate(self._clique_tuples()):
            lanes = np.ones(len(widx), dtype=bool)
            yield ScheduleEvent(
                k=k, time=t, n=n, workers=widx, P_sub=P_sub,
                grad_lanes=lanes, restart_lanes=lanes,
                edges=edges, param_copies_sent=copies,
                finish_lanes=fin,
            )

    def _native_packed_stream(self) -> Optional[PackedEventStream]:
        return CliquePackedStream(self, self._clique_tuples())

    # expose for diagnostics
    def make_pathsearch(self) -> PathSearchState:
        return PathSearchState(self.graph)


class SyncScheduler(Scheduler):
    """Synchronous DSGD (eq. 2): every iteration waits for *all* workers."""

    name = "dsgd_sync"
    global_events = True  # every event is a full barrier: sparse buys nothing

    def events(self) -> Iterator[ScheduleEvent]:
        n = self.n
        edge_list = self.graph.edges
        # The barrier mixes the whole static graph every iteration: one dense
        # Metropolis build up front, shared by every event (m = n, so the
        # "submatrix" is the full matrix and the dense view is pre-cached).
        P = metropolis_matrix(n, edge_list)
        workers = np.arange(n, dtype=np.int32)
        edges = (np.asarray(edge_list, dtype=np.int32).reshape(-1, 2)
                 if edge_list else _EMPTY_EDGES)
        t = 0.0
        k = 0
        while True:
            dur = self.sampler.sample_all()  # one draw, as before
            fin = t + dur                    # per-worker completion clocks
            t += float(dur.max())            # barrier: slowest worker
            # independent mask copies per role (a consumer mutating one view
            # must not flip the other); P is shared across events as before
            gl = np.ones(n, dtype=bool)
            rl = np.ones(n, dtype=bool)
            yield ScheduleEvent(
                k=k, time=t, n=n, workers=workers, P_sub=P,
                grad_lanes=gl, restart_lanes=rl, edges=edges,
                param_copies_sent=2 * len(edge_list),
                dense_P=P, dense_grad=gl, dense_restart=rl,
                finish_lanes=fin,
            )
            k += 1

    def _sync_tuples(self) -> Iterator[tuple]:
        n = self.n
        edge_list = self.graph.edges
        P = metropolis_matrix(n, edge_list)
        workers = np.arange(n, dtype=np.int32)
        edges = (np.asarray(edge_list, dtype=np.int32).reshape(-1, 2)
                 if edge_list else _EMPTY_EDGES)
        copies = 2 * len(edge_list)
        t = 0.0
        while True:
            dur = self.sampler.sample_all()
            fin = t + dur
            t += float(dur.max())
            yield (t, workers, P, edges, copies, fin)

    def _native_packed_stream(self) -> Optional[PackedEventStream]:
        # The runner never routes the barrier stream through the sparse
        # path (global_events forces the dense fallback), but the packed
        # round-trip tests cover all five schedulers, so keep it native.
        return CliquePackedStream(self, self._sync_tuples())
