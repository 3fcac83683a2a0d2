"""Baseline schedulers the paper compares against (§6): AD-PSGD, Prague, AGP.

Each baseline is expressed as a scheduler emitting the same ``ScheduleEvent``
stream as DSGD-AAU, so the *identical* JAX update (core/aau.py) runs all
algorithms — only the (N(k), P(k)) sequence differs.  This mirrors the paper's
framing where every algorithm is an instance of eq. (5) with a different
consensus-matrix process.

Events are sparse-native (see core/scheduler.py): a single-edge event is two
int32 lanes plus a 2×2 submatrix, never an (n, n) matrix, which keeps event
*generation* O(1) per event — the host-side heap loop used to be the
consumer's ceiling at paper scale.  Per-scheduler ``edge_bound`` /
``active_bound`` overrides keep the packed arrays at their true width
(AD-PSGD/AGP touch one edge per event, Prague at most one group's clique)
instead of the full graph's.  Because every baseline's events all share one
size, the bucketed lane-width contract (``Scheduler.active_buckets``)
stays at its degenerate single-bucket default — ``(2,)`` for the
single-edge pair, ``(group_size,)`` for Prague — and the runner's sparse
dispatch is byte-for-byte the single-program path it always was; only
DSGD-AAU, whose finished-clique size is a distribution, carries a
multi-rung ladder.

Event-horizon batching: the single-edge schedulers accept ``horizon=K`` to
pre-draw K future completion-time factors and K neighbor picks in two
vectorized RNG calls, replacing the per-event ``heapq`` push/pop with an
argmin over a numpy reorder buffer of per-worker next-completion times.
The horizon stream is fully deterministic and distributionally identical,
but consumes the RNG streams in a different order than the per-event path
(vector draws cannot interleave with numpy's scalar ziggurat draws), so it
is a *different* realization: leave ``horizon=None`` (the default) wherever
bit-exact reproduction of recorded runs matters.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.scheduler import (_EMPTY_EDGES, CliquePackedStream,
                                  PackedEventStream, Scheduler, ScheduleEvent,
                                  SparseEventBatch)
from repro_torch.scenarios.base import TimeModelSpec
from repro_torch.core.topology import Graph


def _frozen(a: np.ndarray) -> np.ndarray:
    """Shared per-class event payloads: mark read-only so aliasing is safe."""
    a.flags.writeable = False
    return a


# Pairwise-averaging submatrix (AD-PSGD) and per-lane masks for a sorted
# worker pair (a, b): shared across every event of every scheduler instance.
_P_PAIR_AVG = _frozen(np.full((2, 2), 0.5))
_P_SELF = _frozen(np.ones((1, 1)))
# Push-sum split: the *sender's row* keeps half and pushes half (AGP).
_P_PUSH_FIRST = _frozen(np.array([[0.5, 0.5], [0.0, 1.0]]))
_P_PUSH_SECOND = _frozen(np.array([[1.0, 0.0], [0.5, 0.5]]))
_LANE_FIRST = _frozen(np.array([True, False]))
_LANE_SECOND = _frozen(np.array([False, True]))
_LANE_SELF = _frozen(np.ones(1, dtype=bool))


class _PairPackedStream(PackedEventStream):
    """Array-native exact pair stream (AD-PSGD/AGP fast generation path).

    Replays :meth:`_SingleEdgeScheduler._events_exact` — same heap, same
    per-event RNG consumption order (neighbor pick then next completion
    draw), same lock arithmetic — but writes each event straight into the
    chunk's :class:`SparseEventBatch` arrays: no ``ScheduleEvent`` object,
    no payload tuple, no ``from_events`` re-scatter.  Bit-identical chunks
    to ``packed_stream(native=False)``, pinned by
    tests/test_fused_stream.py.
    """

    def __init__(self, scheduler: "_SingleEdgeScheduler"):
        self.scheduler = scheduler
        self.buckets = scheduler.active_buckets()      # always (2,)
        self._ebound = scheduler.edge_bound()          # always 1
        self._k = 0
        self._lock_free_at = 0.0
        heap: List[Tuple[float, int]] = []
        for i, dt in enumerate(
                scheduler.sampler.sample_batch(np.arange(scheduler.n))):
            heapq.heappush(heap, (dt, i))
        self._heap = heap
        # shared pair payloads, pre-cast once to the packed dtypes
        _, P1, l1, copies = scheduler._pair_payload(0, 1)
        _, P2, l2, _ = scheduler._pair_payload(1, 0)
        self._P1 = np.ascontiguousarray(P1, dtype=np.float32)
        self._P2 = np.ascontiguousarray(P2, dtype=np.float32)
        self._l1 = np.asarray(l1, dtype=bool)
        self._l2 = np.asarray(l2, dtype=bool)
        self._copies = int(copies)

    def next_chunk(self, k: int):
        sched = self.scheduler
        sampler = sched.sampler
        rng = sched._rng
        nbrs_list = sched._nbrs
        lock_dt = sched.lock_time
        heap = self._heap
        push, pop = heapq.heappush, heapq.heappop
        lock_free_at = self._lock_free_at
        P1, P2, l1, l2 = self._P1, self._P2, self._l1, self._l2
        copies_pair = self._copies
        a = CliquePackedStream._alloc(k, 2, self._ebound)
        workers, P_sub = a["workers"], a["P_sub"]
        gm, rm = a["grad_workers"], a["restart_workers"]
        edges, n_edges = a["edges"], a["n_edges"]
        times, n_workers = a["times"], a["n_workers"]
        copies = a["param_copies_sent"]
        finish = a["finish"]
        for j in range(k):
            t, i = pop(heap)
            t_raw = t                  # raw completion, before any lock wait
            nbrs = nbrs_list[i]
            m = len(nbrs)
            if m:
                if lock_dt:
                    t = (t if t > lock_free_at else lock_free_at) + lock_dt
                    lock_free_at = t
                r = int(nbrs[rng.integers(0, m)])
                # the finisher's lane carries its raw completion clock; the
                # passive partner (rm=False) reads the event clock
                finish[j] = t
                finish[j, 0 if i < r else 1] = t_raw
                if i < r:
                    workers[j, 0] = i
                    workers[j, 1] = r
                    P_sub[j] = P1
                    gm[j] = l1
                    rm[j] = l1
                    edges[j, 0, 0] = i
                    edges[j, 0, 1] = r
                else:
                    workers[j, 0] = r
                    workers[j, 1] = i
                    P_sub[j] = P2
                    gm[j] = l2
                    rm[j] = l2
                    edges[j, 0, 0] = r
                    edges[j, 0, 1] = i
                n_workers[j] = 2
                n_edges[j] = 1
                copies[j] = copies_pair
            else:
                workers[j, 0] = i
                n_workers[j] = 1
                P_sub[j, 0, 0] = 1.0
                gm[j, 0] = True
                rm[j, 0] = True
                finish[j] = t          # no lock: fires at its own completion
            times[j] = t
            push(heap, (t + sampler.sample(i), i))
        self._lock_free_at = lock_free_at
        batch = SparseEventBatch(k0=self._k, **a)
        self._k += k
        return batch


class _SingleEdgeScheduler(Scheduler):
    """Shared machinery for the one-edge-per-event baselines (AD-PSGD, AGP).

    Subclasses define the pair event via ``_pair_payload`` and whether an
    event serializes on the atomic-averaging lock (``lock_time`` > 0).
    """

    lock_time = 0.0

    #: Sampler surface (checked by repro.check's rng-order rule): the only
    #: methods allowed to draw from ``self._rng``.  The draw order *is* the
    #: pinned event stream — a draw anywhere else forks it silently.
    #: ``_PairPackedStream.next_chunk`` draws via ``sched._rng`` on the
    #: scheduler's behalf as the vectorized replay of ``_events_exact``.
    rng_methods = ("_events_exact", "_events_horizon", "fused_draws")

    def __init__(self, graph: Graph, straggler: TimeModelSpec, seed: int,
                 horizon: Optional[int] = None):
        super().__init__(graph, straggler)
        self._rng = np.random.default_rng(seed)
        if horizon is not None and horizon < 1:
            raise ValueError("horizon must be a positive chunk size or None")
        self.horizon = horizon
        self._nbrs = graph.neighbor_lists

    def edge_bound(self) -> int:
        return 1  # one pairwise exchange per event

    def active_bound(self) -> int:
        return 2  # the finisher and its chosen neighbor

    # -- subclass hooks ----------------------------------------------------
    def _pair_payload(self, i: int, r: int):
        """(workers, P_sub, grad_lanes, copies) for finisher i and pick r."""
        raise NotImplementedError

    def _pair_event(self, k: int, t: float, i: int, r: int,
                    t_raw: Optional[float] = None) -> ScheduleEvent:
        workers, P_sub, lanes, copies = self._pair_payload(i, r)
        a = int(workers[0])
        b = int(workers[1])
        # the finisher's lane carries its raw (pre-lock) completion clock;
        # the passive partner's lane reads the event clock (its restart mask
        # is False — telemetry never splits busy/idle on it)
        fin = np.full(2, t)
        fin[0 if i < r else 1] = t if t_raw is None else t_raw
        return ScheduleEvent(
            k=k, time=t, n=self.n, workers=workers, P_sub=P_sub,
            grad_lanes=lanes, restart_lanes=lanes,
            edges=np.array(((a, b),), dtype=np.int32),
            param_copies_sent=copies, finish_lanes=fin,
        )

    def _isolated_event(self, k: int, t: float, i: int) -> ScheduleEvent:
        """A worker with no graph neighbors: purely local gradient step."""
        return ScheduleEvent(
            k=k, time=t, n=self.n,
            workers=np.array((i,), dtype=np.int32), P_sub=_P_SELF,
            grad_lanes=_LANE_SELF, restart_lanes=_LANE_SELF,
            edges=_EMPTY_EDGES, param_copies_sent=0,
        )

    def _needs_sorted_emission(self) -> bool:
        """Lock-shifted and lock-free event times can interleave out of
        order only when the lock exists *and* some worker skips it (no
        neighbors): isolated workers fire at raw completion times while
        locked events fire at the (later) serialized lock times.  Consumers
        bound runs by ``event.time > max_time``, so the stream must stay
        time-sorted — those graphs route events through a small reorder
        heap.  Connected graphs (and lock-free schedulers like AGP) are
        already monotone and skip the buffer entirely.
        """
        return bool(self.lock_time) and any(
            len(nb) == 0 for nb in self._nbrs)

    # -- event generation --------------------------------------------------
    def events(self) -> Iterator[ScheduleEvent]:
        if self.horizon:
            return self._events_horizon(self.horizon)
        return self._events_exact()

    def _native_packed_stream(self) -> Optional[PackedEventStream]:
        # The native stream replays the *exact* per-event RNG order, so a
        # horizon-batched scheduler (different draw order by construction)
        # and the reorder-buffered mixed lock/no-lock graphs keep the
        # object-path adapter.
        if self.horizon or self._needs_sorted_emission():
            return None
        return _PairPackedStream(self)

    # -- fused pure-JAX generation (core/fused.py) -------------------------
    def fused_supported(self) -> bool:
        """Whether the on-device fused generator can replay this stream.

        Requires per-worker completion-time factors that are iid draws
        (``TimeModel.iid_horizon``): the fused scan pre-draws a flat factor
        stream and assigns factors to workers *by event order decided on
        device*, which is only distribution-preserving when the factor law
        doesn't depend on which worker consumes it.  Scenario samplers with
        worker- or history-dependent factors (diurnal) are excluded.
        """
        return bool(getattr(self.sampler, "iid_horizon", False))

    def fused_spec(self) -> Dict[str, object]:
        """Static device constants for the fused generator's scan body."""
        n = self.n
        deg = np.fromiter((len(nb) for nb in self._nbrs),
                          dtype=np.int32, count=n)
        width = max(1, int(deg.max(initial=1)))
        nbr_table = np.zeros((n, width), dtype=np.int32)
        for i, nb in enumerate(self._nbrs):
            if len(nb):
                nbr_table[i, :len(nb)] = nb
        _, P1, l1, copies = self._pair_payload(0, 1)
        _, P2, l2, _ = self._pair_payload(1, 0)
        return dict(
            n=n, deg=deg, nbr_table=nbr_table,
            base=np.asarray(self.sampler.base, dtype=np.float32),
            lock_dt=float(self.lock_time),
            P_first=np.asarray(P1, dtype=np.float32),
            P_second=np.asarray(P2, dtype=np.float32),
            lane_first=np.asarray(l1, dtype=bool),
            lane_second=np.asarray(l2, dtype=bool),
            copies_pair=int(copies),
        )

    def fused_draws(self, E: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host RNG for one fused block: ``(factors, picks)``, both (E,) f32.

        One ``sample_horizon`` + one uniform vector call per block — the
        horizon batcher's draw order, so the fused stream is a
        different-but-deterministic realization exactly like ``horizon=K``
        (see the module docstring); determinism per (seed, block size) is
        pinned by tests/test_fused_stream.py.
        """
        factors = np.asarray(self.sampler.sample_horizon(E), dtype=np.float32)
        picks = self._rng.random(E).astype(np.float32)
        return factors, picks

    def fused_initial_times(self) -> np.ndarray:
        """(n,) f32 first completion times (same draw as the heap init)."""
        return np.asarray(self.sampler.sample_batch(np.arange(self.n)),
                          dtype=np.float32)

    def _events_exact(self) -> Iterator[ScheduleEvent]:
        """The canonical stream: RNG draws happen per event, in event order,
        so recorded runs replay bit-exactly across refactors."""
        n = self.n
        sampler = self.sampler
        rng = self._rng
        nbrs_list = self._nbrs
        lock_dt = self.lock_time
        heap: List[Tuple[float, int]] = []
        for i, dt in enumerate(sampler.sample_batch(np.arange(n))):
            heapq.heappush(heap, (dt, i))
        push, pop = heapq.heappush, heapq.heappop
        # Reorder heap for time-sorted emission (only engaged on graphs that
        # mix locked and lock-free events — see _needs_sorted_emission): an
        # event computed at heap-pop time t can be emitted once the pop
        # clock reaches its (possibly lock-shifted) time, because every
        # later-computed event's time is >= the pop clock.
        out: Optional[List[Tuple[float, int, ScheduleEvent]]] = (
            [] if self._needs_sorted_emission() else None)
        seq = 0
        k = 0
        lock_free_at = 0.0
        while True:
            t, i = pop(heap)
            t_raw = t
            if out is not None:
                while out and out[0][0] <= t:
                    ev = heapq.heappop(out)[2]
                    ev.k = k
                    k += 1
                    yield ev
            nbrs = nbrs_list[i]
            m = len(nbrs)
            if m:
                if lock_dt:
                    # serialized atomic averaging: wait for the lock
                    t = (t if t > lock_free_at else lock_free_at) + lock_dt
                    lock_free_at = t
                r = int(nbrs[rng.integers(0, m)])
                ev = self._pair_event(k, t, i, r, t_raw=t_raw)
            else:
                # an isolated worker averages with nobody: no neighbor draw,
                # no lock acquisition, no copies moved — its gradient lands
                # at its own completion time
                ev = self._isolated_event(k, t, i)
            if out is None:
                k += 1
                yield ev
            else:
                heapq.heappush(out, (float(t), seq, ev))
                seq += 1
            push(heap, (t + sampler.sample(i), i))

    def _events_horizon(self, K: int) -> Iterator[ScheduleEvent]:
        """Event-horizon batching: K events' RNG ahead of time, argmin pops.

        Draws K completion-time factors (one lognormal + one uniform vector
        call, ``TimeSampler.sample_horizon``) and K neighbor picks (one
        uniform vector call) per chunk, and replaces the heap with a (n,)
        numpy reorder buffer of next-completion times — per-event work is
        one ``argmin`` plus array stores.  Deterministic, but a different
        RNG-stream order than :meth:`_events_exact` (see module docstring).
        """
        n = self.n
        sampler = self.sampler
        base = sampler.base
        nbrs_list = self._nbrs
        lock_dt = self.lock_time
        times = np.asarray(sampler.sample_batch(np.arange(n)), dtype=np.float64)
        out: Optional[List[Tuple[float, int, ScheduleEvent]]] = (
            [] if self._needs_sorted_emission() else None)
        seq = 0
        k = 0
        lock_free_at = 0.0
        while True:
            factors = sampler.sample_horizon(K)
            picks = self._rng.random(K)
            for j in range(K):
                i = int(times.argmin())
                t = float(times[i])
                t_raw = t
                if out is not None:
                    while out and out[0][0] <= t:
                        ev = heapq.heappop(out)[2]
                        ev.k = k
                        k += 1
                        yield ev
                nbrs = nbrs_list[i]
                m = len(nbrs)
                if m:
                    if lock_dt:
                        t = (t if t > lock_free_at else lock_free_at) + lock_dt
                        lock_free_at = t
                    r = int(nbrs[int(picks[j] * m)])
                    ev = self._pair_event(k, t, i, r, t_raw=t_raw)
                else:
                    ev = self._isolated_event(k, t, i)
                if out is None:
                    k += 1
                    yield ev
                else:
                    heapq.heappush(out, (t, seq, ev))
                    seq += 1
                times[i] = t + base[i] * factors[j]


class ADPSGDScheduler(_SingleEdgeScheduler):
    """AD-PSGD [Lian et al. 2018].

    A worker that finishes its gradient immediately averages pairwise with one
    uniformly-random graph-neighbor and restarts; the neighbor is *not*
    interrupted — its in-flight gradient will later be applied to the averaged
    parameters (staleness).  Atomic-update requirement (paper §3 / Prague's
    motivation): conflicting concurrent averagings must serialize, so each
    average occupies the "update lock" for ``avg_time`` virtual seconds and
    queued workers wait — the throughput ceiling that makes AD-PSGD stop
    scaling with N.  Workers with no neighbors never average, so they skip
    the lock entirely and send nothing.  P(k) is doubly stochastic: identity
    except a 2×2 block of 1/2.
    """

    name = "ad_psgd"

    def __init__(self, graph: Graph, straggler: TimeModelSpec, seed: int = 1,
                 avg_time: float = 0.05, horizon: Optional[int] = None):
        super().__init__(graph, straggler, seed=seed, horizon=horizon)
        self.avg_time = avg_time * straggler.base_time
        self.lock_time = self.avg_time

    def _pair_payload(self, i: int, r: int):
        if i < r:
            return (np.array((i, r), dtype=np.int32), _P_PAIR_AVG,
                    _LANE_FIRST, 2)
        return (np.array((r, i), dtype=np.int32), _P_PAIR_AVG,
                _LANE_SECOND, 2)


class PragueScheduler(Scheduler):
    """Prague [Luo et al. 2020]: partial all-reduce over randomized groups.

    A Group Generator assigns each finishing worker to a random group of size
    ``group_size``; the group's partial all-reduce fires once *all* members
    have finished their current local computation, then members restart.
    Groups are logical (not topology-constrained), as in the paper.  Because
    membership is random, stragglers still land in groups and stall their
    groupmates — the effect DSGD-AAU avoids.
    """

    name = "prague"

    #: rng-order sampler surface: group membership is the only draw.
    rng_methods = ("_group_tuples",)

    def __init__(self, graph: Graph, straggler: TimeModelSpec,
                 group_size: int = 4, seed: int = 2):
        super().__init__(graph, straggler)
        self.group_size = max(2, min(group_size, graph.n))
        self._rng = np.random.default_rng(seed)

    def edge_bound(self) -> int:
        g = self.group_size
        return g * (g - 1) // 2  # one group clique per event

    def active_bound(self) -> int:
        return self.group_size  # one group's members per event

    def _group_tuples(self) -> Iterator[tuple]:
        """The Prague event process as packed-ready clique tuples.

        Yields ``(t, workers, P_sub, edges, copies, finish)`` per group
        all-reduce — ``finish`` the members' raw completion clocks (the
        group fires when its *last* member finishes; earlier members waited
        since their own) — the single source of truth consumed both by
        :meth:`events` (object wrapper) and by the array-native
        :class:`CliquePackedStream`.
        """
        n = self.n
        heap: List[Tuple[float, int]] = []
        for i, dt in enumerate(self.sampler.sample_batch(np.arange(n))):
            heapq.heappush(heap, (dt, i))
        finish_at = np.zeros(n, dtype=np.float64)
        in_group: Dict[int, int] = {}          # worker -> group id
        groups: Dict[int, Set[int]] = {}       # group id -> members
        ready: Dict[int, Set[int]] = {}        # group id -> members finished
        next_gid = 0
        while True:
            t, i = heapq.heappop(heap)
            finish_at[i] = t
            if i not in in_group:
                # Group Generator: form a fresh group around i from workers
                # not currently claimed by a pending group.
                free = [w for w in range(n) if w != i and w not in in_group]
                size = min(self.group_size - 1, len(free))
                members = {i} | set(
                    int(x) for x in self._rng.choice(free, size=size, replace=False)
                ) if size > 0 else {i}
                gid = next_gid
                next_gid += 1
                groups[gid] = members
                ready[gid] = set()
                for m in members:
                    in_group[m] = gid
            gid = in_group[i]
            ready[gid].add(i)
            if ready[gid] != groups[gid]:
                continue  # group still waiting on a member (possibly a straggler)
            members = sorted(groups[gid])
            g = len(members)
            widx = np.asarray(members, dtype=np.int32)
            # the group's partial all-reduce: a g×g block of 1/g, identity
            # outside — built at its true size, never as an (n, n) matrix
            iu, ju = np.triu_indices(g, k=1)
            yield (t, widx, np.full((g, g), 1.0 / g),
                   np.stack([widx[iu], widx[ju]], axis=1) if g > 1
                   else _EMPTY_EDGES,
                   # ring partial all-reduce: 2·(g−1)/g vector-copies per member
                   2 * (g - 1), finish_at[widx].copy())
            for m, dt in zip(members, self.sampler.sample_batch(members)):
                del in_group[m]
                heapq.heappush(heap, (t + dt, m))
            del groups[gid], ready[gid]

    def events(self) -> Iterator[ScheduleEvent]:
        n = self.n
        for k, (t, widx, P_sub, edges, copies, fin) in \
                enumerate(self._group_tuples()):
            lanes = np.ones(len(widx), dtype=bool)
            yield ScheduleEvent(
                k=k, time=t, n=n, workers=widx, P_sub=P_sub,
                grad_lanes=lanes, restart_lanes=lanes,
                edges=edges, param_copies_sent=copies,
                finish_lanes=fin,
            )

    def _native_packed_stream(self) -> Optional[PackedEventStream]:
        return CliquePackedStream(self, self._group_tuples())


class AGPScheduler(_SingleEdgeScheduler):
    """Asynchronous Gradient Push [Assran & Rabbat 2020].

    Push-sum on a directed view of the graph: a finishing worker applies its
    gradient, keeps half of its (parameter, weight) mass and pushes the other
    half to one random out-neighbor.  In the paper's W·P(k) orientation
    (out_j = Σ_i P_ij·W_i) the push matrix is *row*-stochastic only (each
    sender's row distributes its mass), i.e. the transpose of the
    column-stochastic matrix in AGP's x ← A·x notation; the runner de-biases
    estimates with the push-sum weight vector y(k) = y(k−1)·P(k).
    """

    name = "agp"

    def __init__(self, graph: Graph, straggler: TimeModelSpec, seed: int = 3,
                 horizon: Optional[int] = None):
        super().__init__(graph, straggler, seed=seed, horizon=horizon)

    def _pair_payload(self, i: int, r: int):
        # sender i's ROW splits its mass between i and r; one directed push
        if i < r:
            return (np.array((i, r), dtype=np.int32), _P_PUSH_FIRST,
                    _LANE_FIRST, 1)
        return (np.array((r, i), dtype=np.int32), _P_PUSH_SECOND,
                _LANE_SECOND, 1)


def make_scheduler(name: str, graph: Graph, straggler: TimeModelSpec, **kw) -> Scheduler:
    from repro_torch.core.scheduler import AAUScheduler, SyncScheduler
    table = {
        "dsgd_aau": AAUScheduler,
        "dsgd_sync": SyncScheduler,
        "ad_psgd": ADPSGDScheduler,
        "prague": PragueScheduler,
        "agp": AGPScheduler,
    }
    if name not in table:
        raise KeyError(f"unknown algorithm {name!r}; have {sorted(table)}")
    return table[name](graph, straggler, **kw)
