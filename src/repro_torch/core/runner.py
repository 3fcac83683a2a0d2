"""Decentralized training loop: any scheduler × any model × any data.

The port of the reference's ``repro/core/runner.py`` for the block paths.
It consumes a scheduler's event stream and advances the stacked worker
state with the updates from :mod:`repro_torch.core.aau`, recording loss and
accuracy against the iteration counter and the *virtual wall-clock*, plus
cumulative communication (the paper's Figures 3–5 protocol).

Execution model (``mode="auto"`` picks the path with :func:`choose_mode`):

- ``mode="scan"``: the event stream is packed ``block_size`` events at a
  time into :class:`~repro_torch.core.scheduler.EventBatch` arrays and
  replayed by ``masked_gossip_scan`` -- one ``masked_gossip`` kernel launch
  per leaf per event.  Barrier streams (sync DSGD) always take this path.
- ``mode="sparse_scan"``: the stream arrives as packed active-set chunks;
  multi-rung schedulers (DSGD-AAU) are dispatched bucket segment by
  segment in stream order (``_dispatch_bucketed``), each segment chopped
  into fixed-length chunks (``_bucket_cap``) and, where the lane width is
  small, folded into merged conflict-free rows (``merge_event_groups``).
  Every event gathers only the workers it touches.
- ``mode="per_event"``: the reference's legacy interpreter, one event at a
  time: the elementwise gradient step, then one ``gossip_mix`` launch per
  leaf (``build_event_step``).  Each worker's batch is drawn on the host
  when it restarts, as the reference's legacy path draws it.
- ``mode="fused"``: single-edge schedulers (AD-PSGD, AGP) whose completion
  times are iid draws.  The event process itself runs on the device
  (:class:`~repro_torch.core.fused.FusedPairBlock`): per block the host
  draws completion factors and neighbor picks; each event is picked by
  ``argmin`` over the device clock and applied as a 2-lane active-set
  update.  Runs are bounded by events only.
- In the block and fused modes, per-worker batches come from a sample pool
  drawn ahead of the run and kept on the device, indexed by restart
  counters ``ptr`` the blocks carry.
  The pool is sized from the run's bound (capped at 1024 draws per worker)
  unless ``batch_pool`` pins it; the pointer wraps modulo the pool, with a
  warning when that happens.
- Evaluation fires every ``eval_every`` events; block boundaries snap to
  the eval grid.  Eval scalars accumulate in a device buffer and are
  fetched once when the run ends.

Blocks are not padded to a fixed length as in the reference: PyTorch runs
eagerly, so there is no compiled block shape to keep.

Observability, as in the reference (:mod:`repro_torch.obs`):

- ``telemetry=True``: per-worker counters in a device-resident
  :class:`~repro_torch.obs.metrics.MetricsCarry`, advanced per event
  (``per_event``, ``scan``) or per row (``sparse_scan``), or folded once at
  drain from the fused block's streamed identities; drained once per run
  into ``RunResult.telemetry``, with the per-rung bucket occupancy;
- ``trace=True``: the event-identity stream recorded on the host (the
  fused mode's in one fetch at drain), its wait-blame summary in
  ``RunResult.trace`` and the :class:`~repro_torch.obs.trace.Trace` in
  ``trainer.last_trace``;
- ``run_log``: a JSONL :class:`~repro_torch.obs.runlog.RunLogger`;
- ``sanitize``: the run inside
  :func:`~repro_torch.check.runtime.sanitized`, where only explicit
  fetches reach the host;
- host spans (:mod:`repro_torch.obs.spans`: ``sim.run``, ``sim.events``,
  ``sim.pack``, ``sim.dispatch``, ``sim.eval``, ``sim.finish``), recorded
  while a torch profiler runs, on its clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.check.runtime import fetch, sanitize_enabled, sanitized
from repro_torch.core.aau import (build_event_step, debiased_average,
                                  masked_gossip_scan, sparse_gossip_scan,
                                  to_device)
from repro_torch.core.fused import FusedPairBlock
from repro_torch.core.scheduler import (BucketedSparseEventBatch, EventBatch,
                                        Scheduler, SparseEventBatch,
                                        merge_event_groups)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.obs.critical_path import straggler_tax
from repro_torch.obs.metrics import (dense_metrics_update,
                                     fused_metrics_fold, init_metrics,
                                     metrics_summary)
from repro_torch.obs.runlog import RunLogger
from repro_torch.obs.spans import span
from repro_torch.obs.trace import TraceRecorder, drain_fused_payload
from repro_torch.utils.tree import tree_size, tree_stack

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODES = ("auto", "scan", "sparse_scan", "per_event", "fused")
# the CUDA sources each mode's run launches
MODE_KERNELS = {"scan": ("masked_gossip",), "per_event": ("gossip_mix",),
                "sparse_scan": ("sparse_gossip", "scatter_rows"),
                "fused": ("sparse_gossip", "scatter_rows")}


def choose_mode(n: int, buckets: Tuple[int, ...],
                global_events: bool = False) -> str:
    """``mode="auto"``'s dispatch decision: dense ``scan`` vs ``sparse_scan``.

    The reference's recorded crossover: the sparse path wins above
    ``n ≈ 4·A`` for the ladder's narrowest rung, with a floor of n = 16;
    barrier schedulers (``global_events``) always take the dense scan.
    """
    if global_events:
        return "scan"
    if n <= max(16, 4 * buckets[0]):
        return "scan"
    return "sparse_scan"


@dataclasses.dataclass
class HistoryPoint:
    k: int
    time: float
    loss: float
    metric: float
    comm_param_copies: int
    n_active_mean: float


@dataclasses.dataclass
class RunResult:
    algorithm: str
    history: List[HistoryPoint]
    final_loss: float
    final_metric: float
    total_events: int
    total_time: float
    total_comm_copies: int
    param_count: int
    # scalar width of the trainer's dtype policy; with telemetry=True the
    # drained counter summary (repro_torch.obs.metrics.metrics_summary);
    # with trace=True the wait-blame summary
    # (repro_torch.obs.critical_path.straggler_tax), the full Trace on
    # ``trainer.last_trace``
    bytes_per_scalar: int = 4
    telemetry: Optional[Dict] = None
    trace: Optional[Dict] = None

    def comm_bytes(self, bytes_per_scalar: Optional[int] = None) -> int:
        bps = self.bytes_per_scalar if bytes_per_scalar is None else bytes_per_scalar
        return self.total_comm_copies * self.param_count * bps

    def time_to_loss(self, target: float) -> Optional[float]:
        for p in self.history:
            if p.loss <= target:
                return p.time
        return None

    def iters_to_loss(self, target: float) -> Optional[int]:
        for p in self.history:
            if p.loss <= target:
                return p.k
        return None


class DecentralizedTrainer:
    """Runs one algorithm on one model/dataset under one straggler model."""

    def __init__(
        self,
        scheduler: Scheduler,
        loss_fn: Callable,                  # loss_fn(params, batch) -> scalar
        init_params_fn: Callable,           # init_params_fn(generator) -> dict
        worker_batch_fn: Callable,          # worker_batch_fn(worker, step) -> NumPy batch dict
        eval_batch,                         # held-out NumPy batch for the global model
        eval_fn: Optional[Callable] = None, # eval_fn(params, batch) -> (loss, metric)
        eta0: float = 0.1,
        eta_decay: float = 1.0,             # η(k) = η₀ · δ^⌊k/every⌋
        eta_decay_every: int = 1,
        seed: int = 0,
        same_init: bool = True,             # False: one init_params_fn
                                            # draw per worker, in order
        mode: str = "auto",                 # "auto" | "scan" | "sparse_scan"
                                            # | "per_event" | "fused"
        block_size: int = 32,               # events per dense block / chunk
        batch_pool: Optional[int] = None,   # pre-drawn samples per worker
                                            # (None = from the first run's
                                            # bound, cap 1024)
        dtype: str = "float32",             # worker-state dtype policy:
                                            # "float32" | "bfloat16"
        events_per_step: Optional[int] = None,
                                            # sparse path: merge up to K
                                            # conflict-free events per row
                                            # (None = ~64 lanes per row;
                                            # 1 disables)
        native_generation: bool = True,     # sparse path: array-native
                                            # chunk generation where the
                                            # scheduler has it (False: the
                                            # per-event object adapter;
                                            # the stream is bit-identical)
        device: DeviceLike = "cuda",
        telemetry: bool = False,            # device-resident per-worker
                                            # counters, drained once per run
        trace: bool = False,                # record the event-identity
                                            # stream (wait-blame summary)
        run_log: Optional[Union[str, object]] = None,
                                            # JSONL run log: a path, a
                                            # file-like object or None
        sanitize: Optional[bool] = None,    # run inside check.runtime
                                            # .sanitized() (None: the
                                            # REPRO_SANITIZE flag)
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if dtype not in DTYPES:
            raise ValueError(f"dtype policy must be one of {sorted(DTYPES)}, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.dtype = DTYPES[dtype]
        if mode == "auto":
            mode = choose_mode(scheduler.n, scheduler.active_buckets(),
                               scheduler.global_events)
        if mode == "fused" and not (hasattr(scheduler, "fused_spec")
                                    and scheduler.fused_supported()):
            raise ValueError(
                "mode='fused' needs a single-edge scheduler (ad_psgd/agp) "
                "whose time model has iid completion-time factors "
                f"(TimeModel.iid_horizon); got {scheduler.name!r}")
        if mode == "sparse_scan" and scheduler.global_events:
            # barrier streams touch all n workers every event: gathering
            # them is pure overhead, so they take the dense scan
            mode = "scan"
        self.scheduler = scheduler
        self.n = scheduler.n
        self.loss_fn = loss_fn
        self.grad_fn = torch.func.grad(loss_fn)
        self.eval_fn = eval_fn or (lambda p, b: (loss_fn(p, b), 0.0))
        self.worker_batch_fn = worker_batch_fn
        self.eval_batch = self._to_device(eval_batch)
        self.eta0, self.eta_decay = eta0, eta_decay
        self.eta_decay_every = max(1, int(eta_decay_every))
        self.mode = mode
        self.block_size = max(1, block_size)
        self.batch_pool = batch_pool if batch_pool is None else max(1, batch_pool)
        self.events_per_step = events_per_step
        self.native_generation = native_generation
        self.telemetry = bool(telemetry)
        self.trace = bool(trace)
        self.sanitize = bool(sanitize_enabled() if sanitize is None
                             else sanitize)
        self._log = RunLogger(run_log)
        gen = torch.Generator().manual_seed(seed)
        if same_init:
            params = [init_params_fn(gen)] * self.n
        else:
            params = [init_params_fn(gen) for _ in range(self.n)]
        # Push-sum weights y stay float32 under either dtype policy: they
        # are n scalars and de-biasing divides by them.
        self.W = self._cast(self._to_device(tree_stack(params)))
        # S is updated in place by the sparse path, so it never shares W's
        # storage (the reference broke the same alias before donating)
        self.S = {k: v.clone() for k, v in self.W.items()}
        self.y = torch.ones((self.n,), dtype=torch.float32, device=self.device)
        self.param_count = tree_size(params[0])
        self._pools = None          # (n, batch_pool, ...) device sample pools
        self._pool_len = 0
        self._ptr = None            # (n,) int32 restart counters
        self._step = None           # per_event: the event step
        self._batches = None        # per_event: (n, ...) current batches
        self._draw_count = np.zeros(self.n, dtype=np.int64)
        self._pair_block = None     # fused: the generate-and-consume block
        self._pair_clock = None     # fused: (times, lock_free) on the device
        self._set_up = set()        # modes whose update path is set up
        self._metrics = None        # MetricsCarry of the current run
        self._bucket_occ = None     # per-rung occupancy of the current run
        self._fused_payload = None  # fused: per-block device identity
                                    #   streams, folded once at drain
        self._trace = None          # TraceRecorder of the current run
        self.last_trace = None      # finalized Trace of the latest run
        self.sanitizer_stats = None # SanitizerStats of the latest
                                    #   sanitized run

    def _to_device(self, tree) -> Dict[str, torch.Tensor]:
        """A dict of host arrays or tensors on the trainer's device; host
        arrays go up without waiting for queued device work."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.ascontiguousarray(v))
                    ).to(self.device, non_blocking=True)
                for k, v in tree.items()}

    @property
    def _itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _note_set_up(self, key: str) -> None:
        """Log the first set-up of a mode's update path (the reference's
        ``compile`` record)."""
        if key not in self._set_up:
            self._set_up.add(key)
            self._log.log("compile", key=key, telemetry=self.telemetry,
                          trace=self.trace)

    def _cast(self, tree) -> Dict[str, torch.Tensor]:
        """Apply the worker-state dtype policy to a dict's float leaves."""
        return {k: v.to(self.dtype) if v.is_floating_point() else v
                for k, v in tree.items()}

    # -- per_event state ---------------------------------------------------
    def _ensure_per_event(self) -> None:
        if self._step is None:
            self._note_set_up("per_event")
            self._step = build_event_step(self.loss_fn)
            self._batches = self._cast(self._to_device(
                tree_stack([self._draw(i) for i in range(self.n)])))

    def _draw(self, worker: int):
        """Worker ``worker``'s next batch, in the reference's draw order."""
        b = self.worker_batch_fn(worker, int(self._draw_count[worker]))
        self._draw_count[worker] += 1
        return b

    def _refresh_batches(self, idx: np.ndarray) -> None:
        """Redraw the batches of the workers in ``idx`` (restarted lanes) on
        the host and copy their rows into the device batches."""
        if len(idx) == 0:
            return
        new = [self._draw(int(i)) for i in idx]
        at = to_device(idx, torch.int64, self.device)
        for k, leaf in self._batches.items():
            rows = np.stack([np.asarray(b[k]) for b in new])
            leaf.index_copy_(0, at, to_device(rows, leaf.dtype, self.device))

    def _event_operands(self, ev, eta: float):
        """(P, grad_mask, restart_mask, eta) of one event on the device,
        from one host array and one copy."""
        n = self.n
        buf = np.empty(n * n + 2 * n + 1, dtype=np.float32)
        buf[:n * n] = ev.P.reshape(-1)
        buf[n * n:n * n + n] = ev.grad_workers
        buf[n * n + n:-1] = ev.restart_workers
        buf[-1] = eta
        d = to_device(buf, torch.float32, self.device)
        return (d[:n * n].view(n, n), d[n * n:n * n + n] > 0,
                d[n * n + n:-1] > 0, d[-1])

    # -- sample pools ------------------------------------------------------
    def _estimate_restarts(self, max_time: float) -> int:
        """Upper-bound restarts per worker for a ``max_time``-bounded run
        (2× headroom over the fastest worker's base time)."""
        base = np.min(self.scheduler.sampler.base)
        return int(np.ceil(2.0 * max_time / max(float(base), 1e-9)))

    def _ensure_pools(self, max_events: Optional[int] = None,
                      max_time: Optional[float] = None) -> None:
        if self.batch_pool is not None:
            pool_len = self.batch_pool
        elif max_events:
            pool_len = min(max_events, 1024)
        elif max_time is not None:
            pool_len = max(64, min(self._estimate_restarts(max_time), 1024))
        else:
            pool_len = 64
        if self._pools is not None and self._pool_len >= pool_len:
            return
        # pool[i, s] = the s-th batch worker i draws.  A draw is a pure
        # function of (worker, step), so growing the pool keeps the prefix
        # already consumed and the carried ptr stays valid.
        self._pool_len = pool_len
        self._pools = self._cast(self._to_device(tree_stack([
            tree_stack([self.worker_batch_fn(w, s) for s in range(pool_len)])
            for w in range(self.n)])))
        if self._ptr is None:
            self._ptr = torch.zeros((self.n,), dtype=torch.int32,
                                    device=self.device)

    def _etas(self, offsets) -> np.ndarray:
        """Step sizes of the events at stream positions ``offsets``."""
        return self.eta0 * self.eta_decay ** (
            np.asarray(offsets) // self.eta_decay_every)

    # -- dense path --------------------------------------------------------
    def _ensure_scan(self, max_events: Optional[int] = None,
                     max_time: Optional[float] = None) -> None:
        self._note_set_up("scan")
        self._ensure_pools(max_events, max_time)

    def _dispatch_block(self, batch: EventBatch, rounds: int) -> None:
        """Advance (W, S, y, ptr) -- and, with telemetry, the metrics --
        through one dense block."""
        with span("sim.dispatch", events=batch.E) as counts:
            if counts is not None:
                counts["worker_steps"] = int(np.count_nonzero(
                    batch.grad_workers))
            self._log.log("block_dispatch", mode="scan", events=batch.E,
                          rounds=rounds)
            args = (self.W, self.S, self.y, self._ptr, self._pools,
                    self.grad_fn, batch.P, batch.grad_workers,
                    batch.restart_workers,
                    self._etas(rounds + np.arange(batch.E)))
            if not self.telemetry:
                self.W, self.S, self.y, self._ptr = masked_gossip_scan(*args)
                return
            fin = (batch.finish if batch.finish is not None
                   else np.broadcast_to(batch.times[:, None],
                                        (batch.E, self.n)))
            (self.W, self.S, self.y, self._ptr,
             self._metrics) = masked_gossip_scan(
                *args, M=self._metrics,
                tel=(batch.times, fin, rounds + np.arange(batch.E),
                     batch.param_copies_sent))

    # -- fused path --------------------------------------------------------
    def _ensure_fused(self, max_events: Optional[int] = None) -> None:
        if self._pair_block is None:
            self._note_set_up("fused")
            # trace reads the same widened block outputs as telemetry
            self._pair_block = FusedPairBlock(
                self.loss_fn, self.scheduler.fused_spec(), self.device,
                telemetry=self.telemetry or self.trace)
        self._ensure_pools(max_events)

    # -- sparse path -------------------------------------------------------
    def _ensure_sparse(self, max_events: Optional[int] = None,
                       max_time: Optional[float] = None) -> None:
        self._note_set_up("sparse_scan")
        self._ensure_pools(max_events, max_time)

    def _dispatch_sparse_block(self, batch: SparseEventBatch, rounds: int,
                               lane_off: Optional[np.ndarray] = None,
                               lane_ts: Optional[np.ndarray] = None) -> None:
        """Advance the carry through one active-set block, O(A·D) per event.

        ``lane_off`` marks ``batch`` as the output of ``merge_event_groups``:
        (E, A) absolute source-event offsets per lane, from which per-*lane*
        step sizes are built (each merged lane keeps the η its source event
        would have used, so merging stays exact).  ``lane_ts`` (telemetry,
        merged rows) carries the matching per-lane source-event clocks.
        """
        E, A = batch.workers.shape
        with span("sim.dispatch", events=E) as counts:
            if counts is not None:
                counts["worker_steps"] = int(np.count_nonzero(
                    batch.grad_workers))
            self._log.log("block_dispatch", mode="sparse_scan", events=E,
                          lanes=A, rounds=rounds, merged=lane_off is not None)
            offsets = np.arange(E) if lane_off is None else lane_off
            etas = self._etas(rounds + offsets)
            args = (self.W, self.S, self.y, self._ptr, self._pools,
                    self.grad_fn, batch.workers, batch.P_sub,
                    batch.grad_workers, batch.restart_workers, etas)
            if not self.telemetry:
                self.W, self.S, self.y, self._ptr = sparse_gossip_scan(*args)
                return
            # per-lane event indices and clocks: an unmerged row's lanes
            # share its event; a merged row's lanes keep their source event's
            ks = np.broadcast_to((rounds + offsets).reshape(E, -1), (E, A))
            ts = (np.broadcast_to(batch.times[:, None], (E, A))
                  if lane_off is None else lane_ts)
            fin = batch.finish if batch.finish is not None else ts
            (self.W, self.S, self.y, self._ptr,
             self._metrics) = sparse_gossip_scan(
                *args, M=self._metrics,
                tel=(ts, fin, ks, batch.param_copies_sent))

    def _events_per_step(self, A: int) -> int:
        """Events merged per row at lane width ``A``: ``events_per_step``
        when set, else a ~64-lane budget per row (A=2 pairs merge 16-deep,
        A=16 rungs ~4 cliques, A≥64 rungs stay unmerged)."""
        if self.events_per_step is not None:
            return max(1, int(self.events_per_step))
        return int(np.clip(64 // max(A, 1), 1, 16))

    def _dispatch_sparse_chunk(self, batch: SparseEventBatch, rounds: int,
                               cap: int) -> None:
        """Advance the carry through one same-bucket packed chunk: merged
        by ``merge_event_groups`` when K > 1, then cut into ``cap // K``-row
        (``cap`` when unmerged) blocks."""
        K = self._events_per_step(batch.A)
        if K <= 1:
            start = 0
            while start < batch.E:
                stop = min(batch.E, start + cap)
                self._dispatch_sparse_block(batch.slice(start, stop),
                                            rounds + start)
                start = stop
            return
        with span("sim.pack", events=batch.E):
            merged, lane_off = merge_event_groups(batch, K)
        g_cap = max(1, cap // K)
        # telemetry: the lanes' source-event clocks, gathered once a chunk
        lane_ts = batch.times[lane_off] if self.telemetry else None
        start = 0
        while start < merged.E:
            stop = min(merged.E, start + g_cap)
            # lane_off holds absolute source offsets within ``batch``, so
            # ``rounds`` stays the chunk base across slices
            self._dispatch_sparse_block(
                merged.slice(start, stop), rounds,
                lane_off=lane_off[start:stop],
                lane_ts=None if lane_ts is None else lane_ts[start:stop])
            start = stop

    # Base chunk length for the narrowest bucket of a multi-bucket ladder.
    _CHUNK_QUANTUM = 32

    @staticmethod
    def _bucket_cap(buckets: Tuple[int, ...], b: int, target: int) -> int:
        """Chunk length for bucket ``b``: ``quantum · (buckets[0]/buckets[b])²``,
        floored at 1 (the reference's quadratic cap: wide rungs fire in
        1–2-event bursts)."""
        quantum = min(target, DecentralizedTrainer._CHUNK_QUANTUM)
        return max(1, (quantum * buckets[0] * buckets[0])
                   // (buckets[b] * buckets[b]))

    def _dispatch_bucketed(self, bucketed: BucketedSparseEventBatch,
                           rounds: int, target: int) -> None:
        """Advance the carry through a bucketed block in stream order: the
        stream's maximal same-bucket runs, each at its bucket's lane width."""
        for b, off, seg in bucketed.segment_batches():
            cap = self._bucket_cap(bucketed.buckets, b, target)
            self._log.log("bucket_segment", A=int(bucketed.buckets[b]),
                          events=seg.E, rounds=rounds + off)
            self._dispatch_sparse_chunk(seg, rounds + off, cap)

    def _accum_occupancy(self, rows: List[Dict[str, float]]) -> None:
        """Fold one chunk's per-rung packing stats into the run aggregate."""
        for r in rows:
            if not r["events"]:
                continue
            acc = self._bucket_occ.setdefault(int(r["A"]),
                                              {"events": 0, "lanes": 0.0})
            acc["events"] += int(r["events"])
            acc["lanes"] += float(r["lane_fill"]) * r["events"] * r["A"]

    # -- drain ---------------------------------------------------------------
    def _telemetry_summary(self, t_end: float) -> Optional[Dict]:
        """Drain the device counters once (logged before ``run_end``)."""
        if not self.telemetry:
            return None
        if self._fused_payload:
            # fold the whole fused run's streamed identities at once (event
            # indices restart at 0 with the per-run counter reset)
            t_ev, i_seq, p_seq, t_raw = (
                torch.cat(xs) if len(xs) > 1 else xs[0]
                for xs in zip(*self._fused_payload))
            self._metrics = fused_metrics_fold(
                self._metrics, i_seq, p_seq, t_raw, t_ev,
                self._pair_block.copies_pair, 0)
            self._fused_payload = []
        summary = metrics_summary(
            self._metrics, t_end,
            n_minus_1_bound=self.scheduler.name == "dsgd_aau")
        summary["comm_bytes_per_copy"] = self.param_count * self._itemsize
        if self._bucket_occ:
            summary["bucket_occupancy"] = [
                {"A": A, "events": acc["events"],
                 "lane_fill": acc["lanes"] / (acc["events"] * A)}
                for A, acc in sorted(self._bucket_occ.items())]
        bound = summary.get("staleness_bound")
        if bound is not None:
            self._log.log("staleness_bound", **bound)
            if not bound["ok"]:
                self._log.warn_once(
                    "staleness_bound",
                    f"DSGD-AAU staleness monitor: observed max staleness "
                    f"{bound['observed_max']} exceeds the 2N-4 bound "
                    f"({bound['bound']}) induced by the B <= N-1 per-epoch "
                    "commit bound -- the scheduler violated the paper's "
                    "bounded-staleness guarantee.")
        return summary

    def _trace_summary(self) -> Optional[Dict]:
        """Finalize the recorded identity stream; one device fetch at most
        (a fused run's buffered blocks).  Runs before the telemetry drain,
        which consumes the fused payload."""
        if not self.trace:
            return None
        if self._fused_payload:
            self._trace.record_fused(
                *drain_fused_payload(self._fused_payload),
                copies_pair=self._pair_block.copies_pair)
        tr = self._trace.finalize(algorithm=self.scheduler.name,
                                  mode=self.mode)
        self.last_trace = tr
        return straggler_tax(tr)

    def warmup(self, max_events: Optional[int] = None,
               max_time: Optional[float] = None) -> None:
        """Set-up that a timed run should not pay; the state is unchanged.

        Builds (on CUDA) the kernels of this trainer's path and pays the
        first-use costs of ``torch.func``, the kernels and the BLAS handles:

        - ``scan``/``sparse_scan``: draws the sample pools for this bound and
          takes one discarded two-lane gradient; launches no kernel;
        - ``per_event``: draws the first batches and applies one no-op event
          (identity P, all-False masks), which leaves W, S and y exactly as
          they were;
        - ``fused``: draws the pools and advances clones of the state
          through two events of zero draws, then discards them; no
          scheduler RNG is consumed, so the run's stream is untouched.

        Then one eval.
        """
        if self.device.type == "cuda":
            build.build(MODE_KERNELS[self.mode])
        dev = self.device
        if self.mode == "per_event":
            self._ensure_per_event()
            eye = torch.eye(self.n, device=dev)
            off = torch.zeros(self.n, dtype=torch.bool, device=dev)
            self.W, self.S, self.y = self._step(
                self.W, self.S, self.y, self._batches, eye, off, off,
                torch.zeros((), device=dev))
        elif self.mode == "fused":
            self._ensure_fused(max_events)
            clones = ({k: v.clone() for k, v in self.W.items()},
                      {k: v.clone() for k, v in self.S.items()},
                      self.y.clone(), self._ptr.clone())
            zeros = np.zeros(2, dtype=np.float32)
            self._pair_block(
                clones, self._pools, torch.ones(self.n, device=dev),
                torch.zeros(1, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                zeros, zeros, zeros)
        else:
            if self.mode == "scan":
                self._ensure_scan(max_events, max_time)
            else:
                self._ensure_sparse(max_events, max_time)
            lanes = {k: s[:2] for k, s in self.S.items()}
            batch = {k: p[:2, 0] for k, p in self._pools.items()}
            torch.func.vmap(self.grad_fn)(lanes, batch)
        self._eval_row()

    # -- driving loop ------------------------------------------------------
    def run(self, max_events: Optional[int] = None,
            max_time: Optional[float] = None,
            eval_every: int = 10) -> RunResult:
        with span("sim.run"):
            if not (max_events or max_time):
                raise ValueError("bound the run by events or virtual time")
            if self.telemetry:
                # fresh counters per run: event indices (the staleness clock)
                # restart at 0 every run
                self._metrics = init_metrics(self.n, self.device)
                self._bucket_occ = {}
            self._fused_payload = []
            if self.trace:
                self._trace = TraceRecorder(self.n)
            self._log.log("run_start", algorithm=self.scheduler.name, n=self.n,
                          mode=self.mode, max_events=max_events,
                          max_time=max_time, eval_every=eval_every,
                          dtype=str(self.dtype).replace("torch.", ""),
                          telemetry=self.telemetry, trace=self.trace)
            if self.mode == "fused" or getattr(self.scheduler, "horizon", None):
                self._log.warn_once(
                    "rng_order",
                    "event stream is a different-but-deterministic RNG-order "
                    "realization (horizon batching / fused generation): "
                    "distributionally identical to the exact per-event stream, "
                    "not bit-identical to it.", warn=False)
            with self._maybe_sanitized():
                if self.mode == "fused":
                    return self._run_fused(max_events, max_time, eval_every)
                if self.mode == "per_event":
                    return self._run_per_event(max_events, max_time, eval_every)
                if self.mode == "sparse_scan":
                    return self._run_sparse_stream(max_events, max_time,
                                                   eval_every)
                return self._run_scan(max_events, max_time, eval_every)

    @contextlib.contextmanager
    def _maybe_sanitized(self):
        """The runtime sanitizer around the driving loop when enabled: every
        implicit device→host transfer raises; the run's explicit fetches
        are counted in ``sanitizer_stats``."""
        if not self.sanitize:
            yield
            return
        cuda = self.device.type == "cuda"
        self._log.log("sanitize", conversion_guard=True,
                      sync_debug_mode="error" if cuda else None)
        with sanitized(self.device) as stats:
            self.sanitizer_stats = stats
            yield

    def _new_eval_buffer(self, max_events: Optional[int],
                         eval_every: int) -> torch.Tensor:
        rows = max(2, (max_events // eval_every + 2) if max_events else 16)
        return torch.zeros((rows, 2), dtype=torch.float32, device=self.device)

    def _run_scan(self, max_events, max_time, eval_every) -> RunResult:
        self._ensure_scan(max_events, max_time)
        bound = self.scheduler.edge_bound()
        # with eval_every < block_size every block is eval_every events
        target = min(self.block_size, eval_every)
        eval_buf = self._new_eval_buffer(max_events, eval_every)
        meta: List[Tuple[int, float, int, float]] = []  # (k, t, comm, a_mean)
        comm = 0
        active_sizes: List[int] = []
        t = 0.0
        k = -1
        rounds = 0
        buf = []
        stream = self.scheduler.events()
        exhausted = False
        while not exhausted:
            with span("sim.events") as counts:
                # a block ends at the eval grid
                fill = min(target, eval_every - rounds % eval_every)
                while len(buf) < fill:
                    try:
                        ev = next(stream)
                    except StopIteration:  # finite custom stream: flush
                        ev = None
                    if (ev is None
                            or (max_events is not None and ev.k >= max_events)
                            or (max_time is not None and ev.time > max_time)):
                        exhausted = True
                        break
                    buf.append(ev)
                    k, t = ev.k, ev.time
                    comm += ev.param_copies_sent
                    active_sizes.append(ev.n_active)
                if counts is not None:
                    counts["events"] = len(buf)
            if not buf:
                break
            if self.trace:
                # recorded before packing: the same object events the
                # per-event path replays
                self._trace.record_events(buf)
            with span("sim.pack", events=len(buf)):
                batch = EventBatch.from_events(buf, edge_bound=bound)
            self._dispatch_block(batch, rounds)
            rounds += len(buf)
            buf = []
            if rounds % eval_every == 0:
                eval_buf = self._record_eval(eval_buf, len(meta))
                meta.append((k, t, comm,
                             float(np.mean(active_sizes[-eval_every:]))))
        return self._finish(eval_buf, meta, k, t, comm, rounds, active_sizes)

    def _run_per_event(self, max_events, max_time, eval_every) -> RunResult:
        """The legacy interpreter: one event step per scheduler event, the
        restarted workers' next batches drawn on the host after it."""
        self._ensure_per_event()
        eval_buf = self._new_eval_buffer(max_events, eval_every)
        meta: List[Tuple[int, float, int, float]] = []  # (k, t, comm, a_mean)
        comm = 0
        active_sizes: List[int] = []
        t = 0.0
        k = -1
        rounds = 0
        for ev in self.scheduler.events():
            if max_events is not None and ev.k >= max_events:
                break
            if max_time is not None and ev.time > max_time:
                break
            k, t = ev.k, ev.time
            comm += ev.param_copies_sent
            active_sizes.append(ev.n_active)
            if self.trace:
                self._trace.record_event(ev)
            with span("sim.dispatch", events=1) as counts:
                if counts is not None:
                    counts["worker_steps"] = int(np.count_nonzero(
                        ev.grad_workers))
                P, gm, rm, eta = self._event_operands(ev, self._etas(rounds))
                self.W, self.S, self.y = self._step(
                    self.W, self.S, self.y, self._batches, P, gm, rm, eta)
            if self.telemetry:
                # the event's clock, then the lanes' raw completion clocks
                # scattered over the event-time base
                clocks = np.full(self.n + 1, ev.time)
                if ev.finish_lanes is not None and len(ev.workers):
                    clocks[1 + ev.workers] = ev.finish_lanes
                clocks = to_device(clocks, torch.float32, self.device)
                self._metrics = dense_metrics_update(
                    self._metrics, P, gm, rm, clocks[0], clocks[1:], rounds,
                    ev.param_copies_sent)
            self._refresh_batches(ev.workers[ev.restart_lanes])
            rounds += 1
            if rounds % eval_every == 0:
                eval_buf = self._record_eval(eval_buf, len(meta))
                meta.append((k, t, comm,
                             float(np.mean(active_sizes[-eval_every:]))))
        return self._finish(eval_buf, meta, k, t, comm, rounds, active_sizes)

    def _run_fused(self, max_events, max_time, eval_every) -> RunResult:
        """Drive the generate-and-consume block (``mode="fused"``).

        Per block the host draws the completion factors and neighbor picks;
        who fires, when and with whom is decided on the device.  The
        virtual clock and the copy counter stay on the device and reach the
        host with the eval history, in one fetch at the end, so runs are
        bounded by ``max_events`` only.
        """
        if not max_events:
            raise ValueError(
                "mode='fused' runs are bounded by max_events; max_time is "
                "unsupported (the virtual clock lives on the device -- "
                "bounding by it would force a host sync per block)")
        if max_time is not None:
            raise ValueError("mode='fused' does not support max_time")
        sched = self.scheduler
        dev = self.device
        self._ensure_fused(max_events)
        copies_pair = self._pair_block.copies_pair
        if self._pair_clock is None:
            self._pair_clock = (
                to_device(sched.fused_initial_times(), torch.float32, dev),
                torch.zeros(1, dtype=torch.float32, device=dev))
        times, lock_free = self._pair_clock
        comm = torch.zeros(1, dtype=torch.int64, device=dev)
        carry = (self.W, self.S, self.y, self._ptr)
        blk = max(1, min(self.block_size, eval_every, max_events))
        # eval rows: [loss, metric, t_last, comm]
        eval_buf = torch.zeros((2, 4), dtype=torch.float32, device=dev)
        meta: List[Tuple[int, int]] = []  # (k, rounds_at_eval)
        rounds = 0
        while rounds < max_events:
            until_eval = eval_every - rounds % eval_every
            E = min(blk, until_eval, max_events - rounds)
            factors, picks = sched.fused_draws(E)
            etas = self._etas(rounds + np.arange(E)).astype(np.float32)
            self._log.log("block_dispatch", mode="fused", events=E,
                          rounds=rounds)
            with span("sim.dispatch", events=E):
                carry, lock_free, comm, ys = self._pair_block(
                    carry, self._pools, times, lock_free, comm, factors,
                    picks, etas)
            if self.telemetry or self.trace:
                # the block's (t_ev, i, p, t_raw) streams stay on the
                # device until the drain folds or fetches them
                self._fused_payload.append(ys)
            t_seq = ys[0]
            rounds += E
            if rounds % eval_every == 0 or rounds >= max_events:
                eval_buf = self._record_eval(eval_buf, len(meta), t_seq[-1:],
                                             comm.to(torch.float32))
                meta.append((rounds - 1, rounds))
        self.W, self.S, self.y, self._ptr = carry
        self._pair_clock = (times, lock_free)
        vals = self._fetch_history(eval_buf, len(meta), rounds)
        # comm is exact through float32 up to 2^24 copies; pair-event counts
        # (comm deltas / copies per pair) back out the mean active-set size:
        # 2 lanes per pair event, 1 per isolated-worker event
        history = []
        prev_comm = 0
        prev_rounds = 0
        for i, (mk, mr) in enumerate(meta):
            loss, metric, tt, commf = (float(v) for v in vals[i])
            comm_i = int(round(commf))
            E_i = mr - prev_rounds
            pairs = ((comm_i - prev_comm) // copies_pair
                     if copies_pair else E_i)
            history.append(HistoryPoint(
                k=mk, time=tt, loss=loss, metric=metric,
                comm_param_copies=comm_i,
                n_active_mean=(E_i + min(pairs, E_i)) / max(E_i, 1)))
            prev_comm, prev_rounds = comm_i, mr
        t_end = history[-1].time
        trc = self._trace_summary()   # before telemetry: it clears payload
        tel = self._telemetry_summary(t_end)
        self._log.log("run_end", rounds=rounds, t=t_end,
                      comm=history[-1].comm_param_copies)
        return RunResult(
            algorithm=sched.name, history=history,
            final_loss=history[-1].loss, final_metric=history[-1].metric,
            total_events=rounds, total_time=t_end,
            total_comm_copies=history[-1].comm_param_copies,
            param_count=self.param_count, bytes_per_scalar=self._itemsize,
            telemetry=tel, trace=trc)

    def _run_sparse_stream(self, max_events, max_time, eval_every) -> RunResult:
        """The sparse path's driving loop, over packed chunks in stream order
        (generated array-natively where the scheduler can, unless
        ``native_generation=False``)."""
        self._ensure_sparse(max_events, max_time)
        target = min(self.block_size, eval_every)
        eval_buf = self._new_eval_buffer(max_events, eval_every)
        meta: List[Tuple[int, float, int, float]] = []  # (k, t, comm, a_mean)
        comm = 0
        active_sizes: List[int] = []
        t = 0.0
        k = -1
        rounds = 0
        stream = self.scheduler.packed_stream(native=self.native_generation)
        exhausted = False
        while not exhausted:
            until_eval = eval_every - rounds % eval_every
            want = min(target, until_eval)
            if max_events is not None:
                want = min(want, max_events - rounds)
            if want <= 0:
                break
            with span("sim.events") as counts:
                chunk = stream.next_chunk(want)
                if chunk is not None:
                    if chunk.E < want:  # finite custom stream ended mid-chunk
                        exhausted = True
                    tms = chunk.stream_times()
                    if max_time is not None and tms[-1] > max_time:
                        exhausted = True
                        j = int(np.argmax(tms > max_time))
                        chunk = chunk.head(j) if j else None
                        tms = tms[:j]
                if counts is not None:
                    counts["events"] = chunk.E if chunk is not None else 0
            if chunk is None:
                break
            comm += int(chunk.stream_copies().sum())
            active_sizes.extend(chunk.stream_n_active().tolist())
            t = float(tms[-1])
            k = rounds + chunk.E - 1
            if self.trace:
                # the pre-merge packed arrays (a bucketed chunk segment by
                # segment, in stream order)
                self._trace.record_chunk(chunk)
            if isinstance(chunk, BucketedSparseEventBatch):
                if self.telemetry:
                    self._accum_occupancy(chunk.occupancy())
                self._dispatch_bucketed(chunk, rounds, target)
            else:
                if self.telemetry:
                    self._accum_occupancy([{
                        "A": int(chunk.A), "events": int(chunk.E),
                        "lane_fill": float(chunk.n_workers.sum())
                        / max(chunk.E * chunk.A, 1)}])
                self._dispatch_sparse_chunk(chunk, rounds, target)
            rounds += chunk.E
            if rounds % eval_every == 0:
                eval_buf = self._record_eval(eval_buf, len(meta))
                meta.append((k, t, comm,
                             float(np.mean(active_sizes[-eval_every:]))))
        return self._finish(eval_buf, meta, k, t, comm, rounds, active_sizes)

    def _fetch_history(self, eval_buf: torch.Tensor, rows: int,
                       rounds: int) -> np.ndarray:
        """The run's eval rows on the host, with the restart counters' max
        for the pool-wrap check, in one explicit fetch."""
        if self._ptr is None:   # per_event draws its batches on the host
            return fetch(eval_buf[:rows])
        vals, max_ptr = fetch(eval_buf[:rows], self._ptr.max())
        if rounds and int(max_ptr) > self._pool_len:
            self._log.warn_once(
                "pool_wrap",
                f"batch pool of {self._pool_len} draws/worker wrapped (max "
                f"restarts {int(max_ptr)}): samples were revisited "
                "cyclically; raise batch_pool (or bound the run by "
                "max_events) for exact per-event sampling semantics.")
        return vals

    # -- on-device eval history -------------------------------------------
    def _eval_row(self) -> torch.Tensor:
        """[loss, metric] of the de-biased network average, on the device."""
        def f32(x):
            # a Python number becomes a device scalar without a copy
            if isinstance(x, torch.Tensor):
                return x.to(torch.float32)
            return torch.full((), float(x), dtype=torch.float32,
                              device=self.device)

        with torch.no_grad():
            loss, metric = self.eval_fn(debiased_average(self.W, self.y),
                                        self.eval_batch)
            return torch.stack([f32(loss), f32(metric)])

    def _record_eval(self, eval_buf: torch.Tensor, i: int,
                     *extra: torch.Tensor) -> torch.Tensor:
        """Write history row ``i`` on the device: [loss, metric] and any
        ``extra`` (1,) columns (the fused mode's clock and copy count); the
        buffer doubles when full."""
        with span("sim.eval"):
            row = torch.cat([self._eval_row(), *extra])
            if i == eval_buf.shape[0]:
                eval_buf = torch.cat([eval_buf, torch.zeros_like(eval_buf)])
            eval_buf[i] = row
            return eval_buf

    def _finish(self, eval_buf, meta, k, t, comm, rounds,
                active_sizes) -> RunResult:
        with span("sim.finish"):
            eval_buf = self._record_eval(eval_buf, len(meta))
            meta.append((k, t, comm,
                         float(np.mean(active_sizes)) if active_sizes else 0.0))
            vals = self._fetch_history(eval_buf, len(meta), rounds)
            history = [
                HistoryPoint(k=mk, time=mt, loss=float(vals[i, 0]),
                             metric=float(vals[i, 1]), comm_param_copies=mc,
                             n_active_mean=ma)
                for i, (mk, mt, mc, ma) in enumerate(meta)]
            trc = self._trace_summary()
            tel = self._telemetry_summary(t)
            self._log.log("run_end", rounds=rounds, t=t, comm=comm)
            return RunResult(
                algorithm=self.scheduler.name, history=history,
                final_loss=history[-1].loss, final_metric=history[-1].metric,
                total_events=rounds, total_time=t, total_comm_copies=comm,
                param_count=self.param_count, bytes_per_scalar=self._itemsize,
                telemetry=tel, trace=trc)


def run_algorithms(
    algorithms: Dict[str, Scheduler],
    make_trainer: Callable[[Scheduler], DecentralizedTrainer],
    **run_kw,
) -> Dict[str, RunResult]:
    """Run several algorithms under identical model/data settings."""
    out = {}
    for name, sched in algorithms.items():
        trainer = make_trainer(sched)
        out[name] = trainer.run(**run_kw)
    return out
