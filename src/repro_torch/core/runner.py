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
- Per-worker batches come from a sample pool drawn ahead of the run and
  kept on the device, indexed by restart counters ``ptr`` the blocks carry.
  The pool is sized from the run's bound (capped at 1024 draws per worker)
  unless ``batch_pool`` pins it; the pointer wraps modulo the pool, with a
  warning when that happens.
- Evaluation fires every ``eval_every`` events; block boundaries snap to
  the eval grid.  Eval scalars accumulate in a device buffer and are
  fetched once when the run ends.

Blocks are not padded to a fixed length as in the reference: PyTorch runs
eagerly, so there is no compiled block shape to keep.  The reference's
``per_event`` and ``fused`` modes and its telemetry, tracing, run log and
sanitizer are not part of the port yet; asking for them raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aau import (debiased_average, masked_gossip_scan,
                                  sparse_gossip_scan)
from repro_torch.core.scheduler import (BucketedSparseEventBatch, EventBatch,
                                        Scheduler, SparseEventBatch,
                                        merge_event_groups)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.utils.tree import tree_size, tree_stack

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    bytes_per_scalar: int = 4


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
        eta_decay: float = 1.0,             # η(k) = η₀ · δᵏ per event
        seed: int = 0,
        mode: str = "auto",                 # "auto" | "scan" | "sparse_scan"
        block_size: int = 32,               # events per dense block / chunk
        batch_pool: Optional[int] = None,   # pre-drawn samples per worker
                                            # (None = from the first run's
                                            # bound, cap 1024)
        dtype: str = "float32",             # worker-state dtype policy:
                                            # "float32" | "bfloat16"
        device: DeviceLike = "cuda",
        telemetry: bool = False,
        trace: bool = False,
        run_log=None,
        sanitize: Optional[bool] = None,
    ):
        if mode in ("per_event", "fused"):
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet; use 'auto', 'scan' or "
                "'sparse_scan'")
        if mode not in ("auto", "scan", "sparse_scan"):
            raise ValueError(
                f"mode must be 'auto', 'scan' or 'sparse_scan', got {mode!r}")
        for name, value in (("telemetry", telemetry), ("trace", trace),
                            ("run_log", run_log), ("sanitize", sanitize)):
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        if dtype not in DTYPES:
            raise ValueError(f"dtype policy must be one of {sorted(DTYPES)}, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.dtype = DTYPES[dtype]
        if mode == "auto":
            mode = choose_mode(scheduler.n, scheduler.active_buckets(),
                               scheduler.global_events)
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
        self.mode = mode
        self.block_size = max(1, block_size)
        self.batch_pool = batch_pool if batch_pool is None else max(1, batch_pool)
        # every worker starts from the same parameters
        p0 = init_params_fn(torch.Generator().manual_seed(seed))
        # Push-sum weights y stay float32 under either dtype policy: they
        # are n scalars and de-biasing divides by them.
        self.W = self._cast(self._to_device(tree_stack([p0] * self.n)))
        # S is updated in place by the sparse path, so it never shares W's
        # storage (the reference broke the same alias before donating)
        self.S = {k: v.clone() for k, v in self.W.items()}
        self.y = torch.ones((self.n,), dtype=torch.float32, device=self.device)
        self.param_count = tree_size(p0)
        self._pools = None          # (n, batch_pool, ...) device sample pools
        self._pool_len = 0
        self._ptr = None            # (n,) int32 restart counters
        self._warned_wrap = False

    def _to_device(self, tree) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in tree.items()}

    def _cast(self, tree) -> Dict[str, torch.Tensor]:
        """Apply the worker-state dtype policy to a dict's float leaves."""
        return {k: v.to(self.dtype) if v.is_floating_point() else v
                for k, v in tree.items()}

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

    def _etas(self, offsets: np.ndarray) -> np.ndarray:
        """Step sizes of the events at stream positions ``offsets``."""
        return self.eta0 * self.eta_decay ** offsets

    # -- dense path --------------------------------------------------------
    def _dispatch_block(self, batch: EventBatch, rounds: int) -> None:
        """Advance (W, S, y, ptr) through one dense block."""
        self.W, self.S, self.y, self._ptr = masked_gossip_scan(
            self.W, self.S, self.y, self._ptr, self._pools, self.grad_fn,
            batch.P, batch.grad_workers, batch.restart_workers,
            self._etas(rounds + np.arange(batch.E)))

    # -- sparse path -------------------------------------------------------
    def _dispatch_sparse_block(self, batch: SparseEventBatch, rounds: int,
                               lane_off: Optional[np.ndarray] = None) -> None:
        """Advance the carry through one active-set block, O(A·D) per event.

        ``lane_off`` marks ``batch`` as the output of ``merge_event_groups``:
        (E, A) absolute source-event offsets per lane, from which per-*lane*
        step sizes are built (each merged lane keeps the η its source event
        would have used, so merging stays exact).
        """
        etas = self._etas(rounds + (np.arange(batch.E) if lane_off is None
                                    else lane_off))
        self.W, self.S, self.y, self._ptr = sparse_gossip_scan(
            self.W, self.S, self.y, self._ptr, self._pools, self.grad_fn,
            batch.workers, batch.P_sub, batch.grad_workers,
            batch.restart_workers, etas)

    @staticmethod
    def _events_per_step(A: int) -> int:
        """Events merged per row at lane width ``A``: a ~64-lane budget per
        row (A=2 pairs merge 16-deep, A=16 rungs ~4 cliques, A≥64 rungs stay
        unmerged)."""
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
        merged, lane_off = merge_event_groups(batch, K)
        g_cap = max(1, cap // K)
        start = 0
        while start < merged.E:
            stop = min(merged.E, start + g_cap)
            # lane_off holds absolute source offsets within ``batch``, so
            # ``rounds`` stays the chunk base across slices
            self._dispatch_sparse_block(merged.slice(start, stop), rounds,
                                        lane_off=lane_off[start:stop])
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
            self._dispatch_sparse_chunk(seg, rounds + off, cap)

    def warmup(self, max_events: Optional[int] = None,
               max_time: Optional[float] = None) -> None:
        """Set-up that a timed run should not pay: draw the sample pools for
        this bound, build (on CUDA) the kernels of this trainer's path, and
        pay the first-use costs of ``torch.func`` and the BLAS handles with
        one discarded two-lane gradient and one eval.  Applies no event and
        launches none of the port's kernels; the state is unchanged."""
        self._ensure_pools(max_events, max_time)
        if self.device.type == "cuda":
            build.build(("masked_gossip",) if self.mode == "scan"
                        else ("sparse_gossip", "scatter_rows"))
        lanes = {k: s[:2] for k, s in self.S.items()}
        batch = {k: p[:2, 0] for k, p in self._pools.items()}
        torch.func.vmap(self.grad_fn)(lanes, batch)
        self._eval_row()

    # -- driving loop ------------------------------------------------------
    def run(self, max_events: Optional[int] = None,
            max_time: Optional[float] = None,
            eval_every: int = 10) -> RunResult:
        if not (max_events or max_time):
            raise ValueError("bound the run by events or virtual time")
        if self.mode == "sparse_scan":
            return self._run_sparse_stream(max_events, max_time, eval_every)
        return self._run_scan(max_events, max_time, eval_every)

    def _new_eval_buffer(self, max_events: Optional[int],
                         eval_every: int) -> torch.Tensor:
        rows = max(2, (max_events // eval_every + 2) if max_events else 16)
        return torch.zeros((rows, 2), dtype=torch.float32, device=self.device)

    def _run_scan(self, max_events, max_time, eval_every) -> RunResult:
        self._ensure_pools(max_events, max_time)
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
            try:
                ev = next(stream)
            except StopIteration:  # finite custom stream: flush what we have
                ev = None
            if (ev is None
                    or (max_events is not None and ev.k >= max_events)
                    or (max_time is not None and ev.time > max_time)):
                exhausted = True
            else:
                buf.append(ev)
                k, t = ev.k, ev.time
                comm += ev.param_copies_sent
                active_sizes.append(ev.n_active)
            # snap block boundaries to the eval grid
            until_eval = eval_every - rounds % eval_every
            flush = len(buf) >= min(target, until_eval) or (exhausted and buf)
            if not flush:
                continue
            self._dispatch_block(EventBatch.from_events(buf, edge_bound=bound),
                                 rounds)
            rounds += len(buf)
            buf = []
            if rounds % eval_every == 0:
                eval_buf = self._record_eval(eval_buf, len(meta))
                meta.append((k, t, comm,
                             float(np.mean(active_sizes[-eval_every:]))))
        self._warn_pool_wrap(rounds)
        return self._finish_scan(eval_buf, meta, k, t, comm, rounds,
                                 active_sizes)

    def _run_sparse_stream(self, max_events, max_time, eval_every) -> RunResult:
        """The sparse path's driving loop, over packed chunks in stream order."""
        self._ensure_pools(max_events, max_time)
        target = min(self.block_size, eval_every)
        eval_buf = self._new_eval_buffer(max_events, eval_every)
        meta: List[Tuple[int, float, int, float]] = []  # (k, t, comm, a_mean)
        comm = 0
        active_sizes: List[int] = []
        t = 0.0
        k = -1
        rounds = 0
        stream = self.scheduler.packed_stream()
        exhausted = False
        while not exhausted:
            until_eval = eval_every - rounds % eval_every
            want = min(target, until_eval)
            if max_events is not None:
                want = min(want, max_events - rounds)
            if want <= 0:
                break
            chunk = stream.next_chunk(want)
            if chunk is None:
                break
            if chunk.E < want:  # finite custom stream ended mid-chunk
                exhausted = True
            tms = chunk.stream_times()
            if max_time is not None and tms[-1] > max_time:
                exhausted = True
                j = int(np.argmax(tms > max_time))
                if j == 0:
                    break
                chunk = chunk.head(j)
                tms = tms[:j]
            comm += int(chunk.stream_copies().sum())
            active_sizes.extend(chunk.stream_n_active().tolist())
            t = float(tms[-1])
            k = rounds + chunk.E - 1
            if isinstance(chunk, BucketedSparseEventBatch):
                self._dispatch_bucketed(chunk, rounds, target)
            else:
                self._dispatch_sparse_chunk(chunk, rounds, target)
            rounds += chunk.E
            if rounds % eval_every == 0:
                eval_buf = self._record_eval(eval_buf, len(meta))
                meta.append((k, t, comm,
                             float(np.mean(active_sizes[-eval_every:]))))
        self._warn_pool_wrap(rounds)
        return self._finish_scan(eval_buf, meta, k, t, comm, rounds,
                                 active_sizes)

    def _warn_pool_wrap(self, rounds: int) -> None:
        max_ptr = int(self._ptr.max()) if rounds else 0
        if max_ptr > self._pool_len and not self._warned_wrap:
            self._warned_wrap = True
            warnings.warn(
                f"batch pool of {self._pool_len} draws/worker wrapped (max "
                f"restarts {max_ptr}): samples were revisited cyclically; "
                "raise batch_pool (or bound the run by max_events) for exact "
                "per-event sampling semantics.", stacklevel=3)

    # -- on-device eval history -------------------------------------------
    def _eval_row(self) -> torch.Tensor:
        """[loss, metric] of the de-biased network average, on the device."""
        with torch.no_grad():
            loss, metric = self.eval_fn(debiased_average(self.W, self.y),
                                        self.eval_batch)
            return torch.stack([
                torch.as_tensor(loss, dtype=torch.float32, device=self.device),
                torch.as_tensor(metric, dtype=torch.float32,
                                device=self.device)])

    def _record_eval(self, eval_buf: torch.Tensor, i: int) -> torch.Tensor:
        row = self._eval_row()
        if i == eval_buf.shape[0]:  # a max_time-bounded run outgrew the buffer
            eval_buf = torch.cat([eval_buf, torch.zeros_like(eval_buf)])
        eval_buf[i] = row
        return eval_buf

    def _finish_scan(self, eval_buf, meta, k, t, comm, rounds,
                     active_sizes) -> RunResult:
        eval_buf = self._record_eval(eval_buf, len(meta))
        meta.append((k, t, comm,
                     float(np.mean(active_sizes)) if active_sizes else 0.0))
        vals = eval_buf[:len(meta)].cpu().numpy()  # the run's one fetch
        history = [
            HistoryPoint(k=mk, time=mt, loss=float(vals[i, 0]),
                         metric=float(vals[i, 1]), comm_param_copies=mc,
                         n_active_mean=ma)
            for i, (mk, mt, mc, ma) in enumerate(meta)]
        return RunResult(
            algorithm=self.scheduler.name, history=history,
            final_loss=history[-1].loss, final_metric=history[-1].metric,
            total_events=rounds, total_time=t, total_comm_copies=comm,
            param_count=self.param_count,
            bytes_per_scalar=torch.empty((), dtype=self.dtype).element_size(),
        )
