"""Virtual-time tracing: per-worker timelines from the drained event stream.

The port's copy of the reference's ``repro/obs/trace.py`` (NumPy only);
:func:`drain_fused_payload` is its PyTorch twin.

Every execution mode of :class:`~repro_torch.core.runner.DecentralizedTrainer`
already materializes, per event, the identity tuple the fused scan streams
— *(event clock, participating workers, per-lane raw completion clocks,
grad/restart lanes, gossip edges, copies sent)*.  :class:`TraceRecorder`
buffers exactly that identity stream and normalizes it into a
:class:`Trace`: flat numpy arrays in stream order, from which per-worker
span timelines, the event dependency DAG and the wait-blame attribution
(:mod:`repro_torch.obs.critical_path`) are all pure host-side derivations.

Recording cost follows the drain-once discipline of the telemetry layer
(:mod:`repro_torch.obs.metrics`):

- ``per_event`` / ``scan`` / ``sparse_scan`` / bucketed dispatch generate
  their streams host-side (``ScheduleEvent`` objects or packed
  ``SparseEventBatch`` arrays), so recording is **zero extra device work
  and zero host drains** — the recorder slices arrays that already exist.
  All four modes record the *pre-merge, pre-pad* stream, so their traces
  are bit-identical to the per-event path's.
- ``fused`` keeps the whole event process on device; the runner buffers
  each block's ``(t_ev, i, p, t_raw)`` scan outputs (the same payload
  telemetry folds) and :func:`drain_fused_payload` fetches the
  concatenation with **exactly one** explicit device→host fetch at run
  end.  The fused realization is a different-but-deterministic RNG
  realization of the stream (see core/fused.py), so its trace is
  internally consistent rather than event-matched to the host modes'.

The Chrome Trace Event Format exporter (:func:`chrome_trace`) renders two
process tracks, loadable in Perfetto / ``chrome://tracing``:

- **pid 0 — virtual time**: one thread per worker; ``compute`` spans
  (previous restart → raw completion), ``wait`` spans (completion → event
  commit, i.e. straggler/lock wait), and gossip edges as ``s``/``f`` flow
  arrows between the coupled workers at the commit instant.
- **pid 1 — wall clock**: built from :class:`~repro_torch.obs.runlog.RunLogger`
  records (every record carries a wall-clock ``ts``); ``block_dispatch``
  spans on the dispatch thread, per-rung ``bucket_segment`` spans on one
  thread per lane width A, ``compile`` instants.  Virtual-time cost and
  wall-time cost per bucket rung sit side by side.

``python -m repro_torch.obs.trace RUN_LOG.jsonl`` builds the wall-clock track
alone from a run-log file (no trainer needed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import IO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.check.runtime import fetch

__all__ = [
    "Trace",
    "TraceRecorder",
    "drain_fused_payload",
    "chrome_trace",
    "wall_track",
    "load_run_log",
    "main",
]


@dataclasses.dataclass
class Trace:
    """A run's normalized event-identity stream (host numpy, stream order).

    Events are indexed ``0..E-1`` in commit order.  Lanes are the ragged
    per-event participant records, flattened with ``lane_ev`` ascending
    (lanes of one event keep the event's worker order — ascending worker
    id for every generator in this repo).  Edges are the gossip pairs the
    event mixed over, as global worker-id endpoints.
    """

    n: int
    times: np.ndarray          # (E,) f64 event commit clocks
    copies: np.ndarray         # (E,) i64 param copies sent
    lane_ev: np.ndarray        # (L,) i64 owning event index, ascending
    lane_worker: np.ndarray    # (L,) i32 global worker id
    lane_fin: np.ndarray       # (L,) f64 raw completion clock (≤ commit)
    lane_grad: np.ndarray      # (L,) bool lane fires a gradient
    lane_restart: np.ndarray   # (L,) bool lane restarts its computation
    edge_ev: np.ndarray        # (M,) i64 owning event index, ascending
    edge_src: np.ndarray       # (M,) i32
    edge_dst: np.ndarray       # (M,) i32
    algorithm: str = ""
    mode: str = ""

    @property
    def n_events(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_lanes(self) -> int:
        return int(self.lane_ev.shape[0])

    def event_bounds(self) -> np.ndarray:
        """(E+1,) lane-array offsets: event k's lanes are
        ``[bounds[k], bounds[k+1])``."""
        return np.searchsorted(self.lane_ev,
                               np.arange(self.n_events + 1, dtype=np.int64))


_EMPTY_CHUNK_KEYS = (
    "times", "copies", "lane_ev", "lane_worker", "lane_fin",
    "lane_grad", "lane_restart", "edge_ev", "edge_src", "edge_dst",
)


class TraceRecorder:
    """Accumulates identity chunks; :meth:`finalize` concatenates once.

    The record methods mirror the runner's per-mode stream forms and are
    all pure host work over arrays the driving loop already holds; the
    only device interaction in the whole trace path is the caller's single
    :func:`drain_fused_payload` fetch for ``mode="fused"``.
    """

    def __init__(self, n: int):
        self.n = int(n)
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._k = 0  # events recorded so far (global stream index base)

    # -- per-mode recording ------------------------------------------------
    def record_event(self, ev) -> None:
        """One ``ScheduleEvent`` (``per_event`` mode)."""
        m = len(ev.workers)
        fin = (np.asarray(ev.finish_lanes, dtype=np.float64)
               if ev.finish_lanes is not None
               else np.full(m, ev.time, dtype=np.float64))
        e = len(ev.edges)
        self._chunks.append({
            "times": np.array([ev.time], dtype=np.float64),
            "copies": np.array([ev.param_copies_sent], dtype=np.int64),
            "lane_ev": np.full(m, self._k, dtype=np.int64),
            "lane_worker": np.asarray(ev.workers, dtype=np.int32),
            "lane_fin": fin,
            "lane_grad": np.asarray(ev.grad_lanes, dtype=bool),
            "lane_restart": np.asarray(ev.restart_lanes, dtype=bool),
            "edge_ev": np.full(e, self._k, dtype=np.int64),
            "edge_src": np.asarray(ev.edges[:, 0], dtype=np.int32)
            if e else np.zeros(0, dtype=np.int32),
            "edge_dst": np.asarray(ev.edges[:, 1], dtype=np.int32)
            if e else np.zeros(0, dtype=np.int32),
        })
        self._k += 1

    def record_events(self, events: Sequence) -> None:
        """A buffered block of ``ScheduleEvent``s (``scan`` mode), recorded
        *before* padding — the trace never sees no-op filler events."""
        for ev in events:
            self.record_event(ev)

    def record_sparse(self, batch) -> None:
        """One packed ``SparseEventBatch`` (sparse path), pre-merge/pad."""
        workers = batch.workers
        E, _A = workers.shape
        valid = workers >= 0
        rows, cols = np.nonzero(valid)
        fin = (batch.finish[rows, cols].astype(np.float64)
               if batch.finish is not None
               else batch.times[rows].astype(np.float64))
        emask = (np.arange(batch.edges.shape[1])[None, :]
                 < batch.n_edges[:, None])
        erows, ecols = np.nonzero(emask)
        self._chunks.append({
            "times": np.asarray(batch.times, dtype=np.float64),
            "copies": np.asarray(batch.param_copies_sent, dtype=np.int64),
            "lane_ev": self._k + rows.astype(np.int64),
            "lane_worker": workers[rows, cols].astype(np.int32),
            "lane_fin": fin,
            "lane_grad": batch.grad_workers[rows, cols].astype(bool),
            "lane_restart": batch.restart_workers[rows, cols].astype(bool),
            "edge_ev": self._k + erows.astype(np.int64),
            "edge_src": batch.edges[erows, ecols, 0].astype(np.int32),
            "edge_dst": batch.edges[erows, ecols, 1].astype(np.int32),
        })
        self._k += E

    def record_chunk(self, chunk) -> None:
        """A sparse-path stream chunk: plain or bucketed.

        A bucketed chunk is recorded segment-by-segment in stream order
        (``segment_batches`` yields the maximal same-bucket runs exactly
        as the dispatcher replays them), so event indices stay the global
        stream indices.
        """
        if hasattr(chunk, "segment_batches"):
            for _b, _off, seg in chunk.segment_batches():
                self.record_sparse(seg)
        else:
            self.record_sparse(chunk)

    def record_fused(self, t_ev: np.ndarray, i_seq: np.ndarray,
                     p_seq: np.ndarray, t_raw: np.ndarray,
                     copies_pair: int) -> None:
        """The fused run's drained identity stream (host arrays).

        Lane rebuild convention (matches ``fused_metrics_fold``): every
        event has one finisher ``i`` (grad = restart lane, completion at
        ``t_raw``) and, when ``p >= 0``, a gossip partner whose own
        computation is untouched — its lane is present (completion shown
        at the commit clock) but fires neither gradient nor restart.
        """
        t_ev = np.asarray(t_ev, dtype=np.float64)
        t_raw = np.asarray(t_raw, dtype=np.float64)
        i = np.asarray(i_seq, dtype=np.int32)
        p = np.asarray(p_seq, dtype=np.int32)
        E = t_ev.shape[0]
        has = p >= 0
        lo = np.where(has, np.minimum(i, p), i).astype(np.int32)
        hi = np.where(has, np.maximum(i, p), i).astype(np.int32)
        w2 = np.stack([lo, hi], axis=1)                   # (E, 2) ascending
        valid2 = np.stack([np.ones(E, dtype=bool), has], axis=1)
        grad2 = (w2 == i[:, None]) & valid2
        fin2 = np.where(grad2, t_raw[:, None], t_ev[:, None])
        rows, cols = np.nonzero(valid2)
        eidx = np.nonzero(has)[0]
        self._chunks.append({
            "times": t_ev,
            "copies": np.where(has, int(copies_pair), 0).astype(np.int64),
            "lane_ev": self._k + rows.astype(np.int64),
            "lane_worker": w2[rows, cols],
            "lane_fin": fin2[rows, cols],
            "lane_grad": grad2[rows, cols],
            "lane_restart": grad2[rows, cols],
            "edge_ev": self._k + eidx.astype(np.int64),
            "edge_src": lo[eidx],
            "edge_dst": hi[eidx],
        })
        self._k += E

    # -- drain -------------------------------------------------------------
    def finalize(self, algorithm: str = "", mode: str = "") -> Trace:
        cat: Dict[str, np.ndarray] = {}
        for key in _EMPTY_CHUNK_KEYS:
            parts = [c[key] for c in self._chunks]
            cat[key] = (np.concatenate(parts) if parts
                        else _empty_like_key(key))
        return Trace(n=self.n, algorithm=algorithm, mode=mode, **cat)


def _empty_like_key(key: str) -> np.ndarray:
    if key in ("times", "lane_fin"):
        return np.zeros(0, dtype=np.float64)
    if key in ("copies", "lane_ev", "edge_ev"):
        return np.zeros(0, dtype=np.int64)
    if key in ("lane_grad", "lane_restart"):
        return np.zeros(0, dtype=bool)
    return np.zeros(0, dtype=np.int32)


def drain_fused_payload(payload: Sequence) -> Tuple[np.ndarray, ...]:
    """Fetch the fused run's buffered identity blocks in ONE device read.

    ``payload`` is the runner's per-block list of ``(t_ev, i, p, t_raw)``
    device tuples; each stream is concatenated on the device
    (``torch.cat``), and the four are fetched with a single explicit
    :func:`~repro_torch.check.runtime.fetch` -- the whole trace subsystem's
    only device→host transfer (the host modes record from arrays the
    driving loop already holds).
    """
    return fetch(*(torch.cat(xs) if len(xs) > 1 else xs[0]
                   for xs in zip(*payload)))


# -- Chrome Trace Event Format export ---------------------------------------

#: 1 unit of virtual time renders as 1 s (Chrome trace ``ts`` is in µs).
_VIRT_US = 1e6
#: Wall-clock ``ts`` fields are seconds since logger construction.
_WALL_US = 1e6


def chrome_trace(trace: Optional[Trace] = None,
                 run_log: Optional[Sequence[Dict]] = None) -> Dict:
    """Build a Chrome Trace Event Format document (JSON-serializable).

    ``trace`` fills the virtual-time process (pid 0, one thread per
    worker); ``run_log`` (a list of RunLogger records) fills the
    wall-clock process (pid 1).  Either may be omitted.
    """
    events: List[Dict] = []
    if trace is not None:
        events.extend(_virtual_track(trace))
    if run_log is not None:
        events.extend(wall_track(run_log))
    other = {}
    if trace is not None:
        other = {"algorithm": trace.algorithm, "mode": trace.mode,
                 "n": trace.n, "events": trace.n_events}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def _virtual_track(trace: Trace, pid: int = 0) -> List[Dict]:
    out: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"virtual time · {trace.algorithm or 'run'}"
                 + (f" ({trace.mode})" if trace.mode else "")},
    }]
    for w in range(trace.n):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": w, "args": {"name": f"worker {w}"}})
    last_restart = np.zeros(trace.n, dtype=np.float64)
    ev = trace.lane_ev
    for j in range(trace.n_lanes):
        if not trace.lane_restart[j]:
            continue
        k = int(ev[j])
        w = int(trace.lane_worker[j])
        fin = float(trace.lane_fin[j])
        t = float(trace.times[k])
        start = float(last_restart[w])
        out.append({
            "name": "compute", "cat": "compute", "ph": "X", "pid": pid,
            "tid": w, "ts": start * _VIRT_US,
            "dur": max(fin - start, 0.0) * _VIRT_US,
            "args": {"event": k},
        })
        if t > fin:
            out.append({
                "name": "wait", "cat": "wait", "ph": "X", "pid": pid,
                "tid": w, "ts": fin * _VIRT_US,
                "dur": (t - fin) * _VIRT_US,
                "args": {"event": k},
            })
        last_restart[w] = t
    for j in range(trace.edge_ev.shape[0]):
        k = int(trace.edge_ev[j])
        ts = float(trace.times[k]) * _VIRT_US
        fid = int(j) + 1
        a, b = int(trace.edge_src[j]), int(trace.edge_dst[j])
        out.append({"name": "gossip", "cat": "gossip", "ph": "s",
                    "pid": pid, "tid": a, "ts": ts, "id": fid,
                    "args": {"event": k}})
        out.append({"name": "gossip", "cat": "gossip", "ph": "f",
                    "bp": "e", "pid": pid, "tid": b, "ts": ts, "id": fid,
                    "args": {"event": k}})
    return out


#: Wall-track thread ids: dispatch spans on tid 0; a bucketed run's
#: per-rung segments each get the rung's lane width A as their tid.
_WALL_DISPATCH_TID = 0


def wall_track(records: Sequence[Dict], pid: int = 1) -> List[Dict]:
    """Wall-clock spans from RunLogger records (each carries ``ts``).

    ``block_dispatch`` / ``bucket_segment`` records mark span *starts*;
    a span's duration is the gap to the next timestamped record (the
    dispatch loop logs before launching each block, so consecutive
    records bracket the launch + host packing work).  ``compile`` and the
    remaining lifecycle records render as instants.
    """
    recs = [r for r in records if isinstance(r.get("ts"), (int, float))]
    recs.sort(key=lambda r: r["ts"])
    out: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "wall clock (run log)"},
    }, {
        "name": "thread_name", "ph": "M", "pid": pid,
        "tid": _WALL_DISPATCH_TID, "args": {"name": "dispatch"},
    }]
    rungs = sorted({int(r["A"]) for r in recs
                    if r.get("event") == "bucket_segment" and "A" in r})
    for a in rungs:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": a, "args": {"name": f"rung A={a}"}})
    for idx, rec in enumerate(recs):
        ts = float(rec["ts"]) * _WALL_US
        nxt = (float(recs[idx + 1]["ts"]) * _WALL_US
               if idx + 1 < len(recs) else ts)
        kind = rec.get("event", "?")
        args = {k: v for k, v in rec.items() if k not in ("event", "ts")}
        if kind == "block_dispatch":
            out.append({
                "name": f"dispatch:{rec.get('mode', '?')}",
                "cat": "dispatch", "ph": "X", "pid": pid,
                "tid": _WALL_DISPATCH_TID, "ts": ts,
                "dur": max(nxt - ts, 0.0), "args": args,
            })
        elif kind == "bucket_segment":
            out.append({
                "name": f"segment A={rec.get('A', '?')}",
                "cat": "dispatch", "ph": "X", "pid": pid,
                "tid": int(rec.get("A", 0)), "ts": ts,
                "dur": max(nxt - ts, 0.0), "args": args,
            })
        else:
            out.append({
                "name": kind, "cat": "lifecycle", "ph": "i", "pid": pid,
                "tid": _WALL_DISPATCH_TID, "ts": ts, "s": "t",
                "args": args,
            })
    return out


# -- run-log CLI -------------------------------------------------------------

def load_run_log(path_or_fh: Union[str, IO[str]]) -> List[Dict]:
    """Parse a RunLogger JSONL file; malformed lines are skipped."""
    if hasattr(path_or_fh, "read"):
        lines = path_or_fh.read().splitlines()
    else:
        with open(path_or_fh, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    records = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Convert a RunLogger JSONL run log into a Chrome Trace "
                    "Event Format file (wall-clock track) for Perfetto / "
                    "chrome://tracing.")
    ap.add_argument("run_log", help="path to the run log (JSONL)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: <run_log>.trace.json)")
    args = ap.parse_args(argv)
    records = load_run_log(args.run_log)
    doc = chrome_trace(run_log=records)
    out = args.out or (args.run_log + ".trace.json")
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    print(f"wrote {out}: {len(doc['traceEvents'])} trace events "
          f"({spans} spans) from {len(records)} log records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
