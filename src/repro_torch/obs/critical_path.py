"""Wait-blame attribution and critical-path extraction over a Trace.

The port's copy of the reference's ``repro/obs/critical_path.py`` (NumPy
only).

The event dependency DAG is implicit in the identity stream: event ``k``
commits when its **gate** — the restarting lane with the latest raw
completion clock — finishes (plus any serialization the scheduler's time
model adds on top, e.g. AD-PSGD's averaging lock).  Each gate's
computation started at its worker's previous restart, i.e. at an earlier
event, which is the DAG edge the critical path follows.

Per event with commit clock ``t``, restarting lanes ``i`` with raw
completions ``fin_i`` and gate ``g = argmax_i fin_i``:

- ``blame[g] += Σ_i (fin_g − fin_i)`` — virtual time the other restarting
  workers spent finished-and-waiting **on worker g**.  This is the
  straggler cost the paper's adaptive neighbor count targets: sync-DSGD
  concentrates it on the slowest workers (everyone waits for the global
  max), DSGD-AAU keeps it small (cliques of already-finished workers),
  and AD-PSGD's gate is always its own single finisher (zero blame).
- ``residual_wait += m·(t − fin_g)`` — wait even the gate itself incurred
  between finishing and committing (m = #restarting lanes): lock
  serialization / barrier-release cost, attributable to the *protocol*
  rather than to any worker.

``Σ blame + residual_wait ≡ Σ per-worker wait`` — and the per-worker
busy/wait vectors reproduce the telemetry layer's ``busy_t``/``idle_t``
accumulators exactly (same spans, f64 instead of f32), so the blame table
is a lossless *decomposition* of the utilization numbers the telemetry
layer reports.

The critical path walks gates backward from the last event; its segments
tile ``[0, t_end]`` exactly (each segment spans the gate's previous
restart → its event's commit), so ``compute_t + wait_t = t_end`` is an
invariant the tests pin.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import Trace

__all__ = ["attribute_wait", "critical_path", "straggler_tax"]


def attribute_wait(trace: Trace) -> Dict[str, np.ndarray]:
    """One forward replay: per-worker blame/busy/wait + gate records.

    Returns a dict of arrays:

    - ``blame`` (n,) f64 — wait attributed to each worker as gate;
    - ``busy`` / ``wait`` (n,) f64 — per-worker compute / finished-waiting
      time (the f64 twins of telemetry's ``busy_t``/``idle_t``);
    - ``residual_wait`` () f64 — protocol wait no worker is blamed for;
    - ``gate_worker``/``gate_fin``/``gate_prev_ev``/``gate_prev_t`` (E,) —
      the per-event gate and its incoming DAG edge, consumed by
      :func:`critical_path` (``gate_worker`` is −1 for events with no
      restarting lane).
    """
    n, E = trace.n, trace.n_events
    gate_worker = np.full(E, -1, dtype=np.int64)
    gate_fin = np.zeros(E, dtype=np.float64)
    gate_prev_ev = np.full(E, -1, dtype=np.int64)
    gate_prev_t = np.zeros(E, dtype=np.float64)
    r = np.asarray(trace.lane_restart, dtype=bool)
    if E == 0 or not r.any():
        return {
            "blame": np.zeros(n), "busy": np.zeros(n), "wait": np.zeros(n),
            "residual_wait": np.float64(0.0),
            "gate_worker": gate_worker, "gate_fin": gate_fin,
            "gate_prev_ev": gate_prev_ev, "gate_prev_t": gate_prev_t,
        }
    # One vectorized pass over the restart lanes (already in ascending
    # event order).  The attribution runs inside every traced run's drain:
    # a per-event Python loop costs more than the fused block itself at
    # bench scale, which would break the < 1.10x overhead contract.
    ev = np.asarray(trace.lane_ev)[r]
    w = np.asarray(trace.lane_worker)[r].astype(np.int64)
    fin = np.asarray(trace.lane_fin)[r].astype(np.float64)
    t = np.asarray(trace.times, dtype=np.float64)[ev]

    # Incoming DAG edge per restart lane: the same worker's previous
    # restart event and its commit clock (0 / −1 before the first).  A
    # stable sort by worker keeps event order within each worker, so the
    # predecessor is simply the previous sorted element.
    order = np.argsort(w, kind="stable")
    prev_t_s = np.concatenate(([0.0], t[order][:-1]))
    prev_ev_s = np.concatenate(([-1], ev[order][:-1]))
    first = np.concatenate(([True], w[order][1:] != w[order][:-1]))
    prev_t_s[first] = 0.0
    prev_ev_s[first] = -1
    prev_t = np.empty_like(prev_t_s)
    prev_t[order] = prev_t_s
    prev_ev = np.empty_like(prev_ev_s)
    prev_ev[order] = prev_ev_s

    busy = np.bincount(w, weights=fin - prev_t, minlength=n)
    wait = np.bincount(w, weights=t - fin, minlength=n)

    # Per-event gate: the first-argmax of fin among the event's restart
    # lanes.  Restart lanes of one event are contiguous; lexsort (stable,
    # primary key ev, secondary −fin) puts the earliest max-fin lane at
    # each group's start — np.argmax tie-breaking, vectorized.
    starts = np.flatnonzero(np.concatenate(([True], ev[1:] != ev[:-1])))
    sizes = np.diff(np.concatenate((starts, [len(ev)])))
    gate = np.lexsort((-fin, ev))[starts]
    gev = ev[starts]
    gw, gfin = w[gate], fin[gate]
    sum_fin = np.add.reduceat(fin, starts)
    blame = np.bincount(gw, weights=sizes * gfin - sum_fin, minlength=n)
    residual = float(np.sum((t[starts] - gfin) * sizes))
    gate_worker[gev] = gw
    gate_fin[gev] = gfin
    gate_prev_ev[gev] = prev_ev[gate]
    gate_prev_t[gev] = prev_t[gate]
    return {
        "blame": blame, "busy": busy, "wait": wait,
        "residual_wait": np.float64(residual),
        "gate_worker": gate_worker, "gate_fin": gate_fin,
        "gate_prev_ev": gate_prev_ev, "gate_prev_t": gate_prev_t,
    }


def critical_path(trace: Trace,
                  attr: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    """Walk the gate chain back from the last event.

    Each segment covers ``[gate's previous restart, event commit]`` on the
    gate worker — consecutive segments abut exactly (the previous restart
    *is* an earlier event's commit), so the path tiles ``[0, t_end]`` and
    ``compute_t + wait_t == t_end``.
    """
    if attr is None:
        attr = attribute_wait(trace)
    segments: List[Dict] = []
    k = trace.n_events - 1
    while k >= 0:
        gw = int(attr["gate_worker"][k])
        if gw < 0:
            break
        gfin = float(attr["gate_fin"][k])
        prev_t = float(attr["gate_prev_t"][k])
        t = float(trace.times[k])
        segments.append({
            "event": int(k), "worker": gw,
            "t_start": prev_t, "t_fin": gfin, "t_commit": t,
            "compute": gfin - prev_t, "wait": t - gfin,
        })
        k = int(attr["gate_prev_ev"][k])
    segments.reverse()
    compute_t = float(sum(s["compute"] for s in segments))
    wait_t = float(sum(s["wait"] for s in segments))
    return {
        "segments": segments,
        "events_on_path": len(segments),
        "compute_t": compute_t,
        "wait_t": wait_t,
        "t_end": float(trace.times[-1]) if trace.n_events else 0.0,
    }


def straggler_tax(trace: Trace, top_k: int = 3) -> Dict[str, object]:
    """The per-run blame summary (JSON-friendly; rides RunResult.trace).

    ``straggler_tax`` is the waiting share of total worker-time,
    ``wait / (busy + wait)`` — the exact complement of telemetry's mean
    utilization, now *decomposed* into per-worker blame plus the
    protocol residual.  The critical-path block reports how much of the
    end-to-end virtual makespan was wait rather than compute.
    """
    attr = attribute_wait(trace)
    cp = critical_path(trace, attr)
    busy_t = float(attr["busy"].sum())
    wait_t = float(attr["wait"].sum())
    span = busy_t + wait_t
    blame = attr["blame"]
    blame_total = float(blame.sum())
    order = np.argsort(blame)[::-1][:max(0, top_k)]
    blame_top = [
        {"worker": int(i), "blame_t": round(float(blame[i]), 6),
         "share": round(float(blame[i] / blame_total), 6)
         if blame_total > 0 else 0.0}
        for i in order if blame[i] > 0]
    return {
        "algorithm": trace.algorithm,
        "mode": trace.mode,
        "n": trace.n,
        "events": trace.n_events,
        "t_end": round(float(trace.times[-1]), 6) if trace.n_events else 0.0,
        "busy_t": round(busy_t, 6),
        "wait_t": round(wait_t, 6),
        "straggler_tax": round(wait_t / span, 6) if span > 0 else 0.0,
        "blame": [round(float(v), 6) for v in blame],
        "blame_total": round(blame_total, 6),
        "residual_wait": round(float(attr["residual_wait"]), 6),
        "blame_top": blame_top,
        "critical_path": {
            "events_on_path": cp["events_on_path"],
            "compute_t": round(cp["compute_t"], 6),
            "wait_t": round(cp["wait_t"], 6),
            "wait_frac": round(cp["wait_t"] / cp["t_end"], 6)
            if cp["t_end"] > 0 else 0.0,
        },
    }
