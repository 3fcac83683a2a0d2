"""Device-resident telemetry accumulators for the event-stream simulators.

The port of the reference's ``repro/obs/metrics.py``.  :class:`MetricsCarry`
is a NamedTuple of small device tensors that rides every execution mode's
carry -- the dense block, the sparse block (bucketed and merged rows), the
per-event step -- and is drained to the host once per run.  The fused mode
folds its streamed event identities into it once, at drain
(:func:`fused_metrics_fold`).

Updates are order-exact across representations, as in the reference: only
integer adds, maxes and scatters; participation tests read from the
consensus matrix's off-diagonal support; per-worker float32 adds where
non-participants add an exact ``+0.0``, at most one add per worker per
step (merged rows have disjoint worker sets); and a pure-integer log2
binning for the staleness histogram.  So the drained counters of
``per_event``, ``scan`` and ``sparse_scan`` (bucketed or merged) agree
exactly with each other and with the reference's.  The updates read the
event arrays and the carry and never touch the worker state.

Staleness: a worker's gradient at event ``k`` was evaluated at the
snapshot of its previous restart, so its staleness is
``k − last_restart_k[w] − 1`` (``last_restart_k`` starts at −1).  For
DSGD-AAU, Pathsearch's per-epoch commit bound B ≤ N−1 (paper Remark 4)
induces the event-staleness bound **2N−4**, which
:func:`metrics_summary` checks (the reference's module docstring gives
the argument).

Where the reference scatters with ``mode="drop"``, this port either adds
an exact zero at a clamped index (adds) or writes through an (n+1)-slot
buffer whose last slot takes the dropped lanes (sets).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import numpy as np
import torch

from repro_torch.check.runtime import fetch
from repro_torch.device import DeviceLike, resolve_device

#: Histogram rungs: bin b counts gradient firings with staleness s where
#: ``floor(log2(s + 1)) == b`` -- bin 0 is s = 0, the last bin absorbs
#: everything from 2^15 − 1 up.
STALE_HIST_BINS = 16

I32 = torch.int32
F32 = torch.float32
Int = Union[int, torch.Tensor]


class MetricsCarry(NamedTuple):
    """Per-worker / scalar telemetry accumulators (all device tensors)."""

    grad_steps: torch.Tensor      # (n,) int32 -- gradient firings per worker
    mix_count: torch.Tensor       # (n,) int32 -- gossip participations
    last_restart_k: torch.Tensor  # (n,) int32 -- event of the last restart,
                                  #   −1 before the first
    last_mix_t: torch.Tensor      # (n,) f32 -- virtual clock of the last mix
    last_restart_t: torch.Tensor  # (n,) f32 -- clock of the last restart
    busy_t: torch.Tensor          # (n,) f32 -- Σ local-computation time
    idle_t: torch.Tensor          # (n,) f32 -- Σ wait time (finish → event)
    stale_max: torch.Tensor       # () int32 -- max gradient staleness
    stale_sum: torch.Tensor       # () int32 -- Σ staleness over firings
    stale_hist: torch.Tensor      # (STALE_HIST_BINS,) int32, log2-binned
    comm_copies: torch.Tensor     # () int32 -- Σ parameter copies sent


def init_metrics(n: int, device: DeviceLike = "cuda") -> MetricsCarry:
    """Fresh accumulators for ``n`` workers on ``device`` (``cuda`` unless
    the caller asks for the CPU)."""
    device = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MetricsCarry(
        grad_steps=z((n,), I32), mix_count=z((n,), I32),
        last_restart_k=torch.full((n,), -1, dtype=I32, device=device),
        last_mix_t=z((n,), F32), last_restart_t=z((n,), F32),
        busy_t=z((n,), F32), idle_t=z((n,), F32),
        stale_max=z((), I32), stale_sum=z((), I32),
        stale_hist=z((STALE_HIST_BINS,), I32), comm_copies=z((), I32))


def _stale_bins(s: torch.Tensor) -> torch.Tensor:
    """``floor(log2(s + 1))`` by integer comparisons (exact), as int64
    indices: ``bin = Σ_j [s + 1 >= 2^j]`` for j = 1..STALE_HIST_BINS−1.
    Negative ``s`` (masked lanes) maps to bin 0; callers add 0 there."""
    thresholds = 2 ** torch.arange(1, STALE_HIST_BINS, dtype=I32,
                                   device=s.device)
    return ((s[..., None] + 1) >= thresholds).sum(-1)


def _staleness(M: MetricsCarry, last_k: torch.Tensor, gm: torch.Tensor,
               ks: Int):
    """(stale_max', stale_sum', histogram bins) of one step's lanes."""
    s = ks - last_k - 1
    stale_max = torch.maximum(M.stale_max,
                              torch.where(gm, s, -1).max().to(I32))
    stale_sum = M.stale_sum + torch.where(gm, s, 0).sum().to(I32)
    return stale_max, stale_sum, _stale_bins(s)


def _coupled(P: torch.Tensor) -> torch.Tensor:
    """Lanes whose row or column of P has off-diagonal mass."""
    nz = P != 0
    nz.diagonal().fill_(False)
    return nz.any(dim=1) | nz.any(dim=0)


def _set_at(x: torch.Tensor, idx: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """``x`` with ``x[idx[a]] = vals[a]``; ``idx == len(x)`` drops the lane
    (the reference's ``.at[idx].set(vals, mode="drop")``)."""
    ext = torch.cat([x, x.new_zeros(1)])
    return ext.index_copy_(0, idx, vals.to(x.dtype))[:-1]


def dense_metrics_update(M: MetricsCarry, P: torch.Tensor, gm: torch.Tensor,
                         rm: torch.Tensor, t: torch.Tensor, fin: torch.Tensor,
                         k: Int, copies: Int) -> MetricsCarry:
    """One dense event's telemetry (``per_event`` and ``scan``).

    P: (n, n) consensus matrix; gm/rm: (n,) bool masks; t: 0-d float32
    event clock; fin: (n,) float32 raw completion clocks (read where
    ``rm``); k: the event index; copies: parameter copies sent.
    """
    coupled = _coupled(P)
    gi = gm.to(I32)
    stale_max, stale_sum, bins = _staleness(M, M.last_restart_k, gm, k)
    zero = torch.zeros((), dtype=F32, device=fin.device)
    return MetricsCarry(
        grad_steps=M.grad_steps + gi,
        mix_count=M.mix_count + coupled.to(I32),
        last_restart_k=torch.where(rm, k, M.last_restart_k),
        last_mix_t=torch.where(coupled, t, M.last_mix_t),
        last_restart_t=torch.where(rm, t, M.last_restart_t),
        busy_t=M.busy_t + torch.where(rm, fin - M.last_restart_t, zero),
        idle_t=M.idle_t + torch.where(rm, t - fin, zero),
        stale_max=stale_max,
        stale_sum=stale_sum,
        stale_hist=M.stale_hist.index_add(0, bins, gi),
        comm_copies=M.comm_copies + copies,
    )


def sparse_metrics_update(M: MetricsCarry, workers: torch.Tensor,
                          P_sub: torch.Tensor, gm: torch.Tensor,
                          rm: torch.Tensor, ts: torch.Tensor,
                          fin: torch.Tensor, ks: torch.Tensor,
                          copies: Int) -> MetricsCarry:
    """One active-set row's telemetry (``sparse_scan``: bucketed and merged
    rows).

    workers: (A,) −1-padded; P_sub: (A, A); gm/rm: (A,) bools; ts/fin:
    (A,) float32 per-lane event / raw-completion clocks (a merged row
    carries each member event's own clock); ks: (A,) int32 per-lane event
    indices; copies: the row's copies (a merged row carries the group sum).
    A worker holds at most one lane per row, so each slot is touched at
    most once.
    """
    n = M.grad_steps.shape[0]
    valid = workers >= 0
    gidx = torch.where(valid, workers, 0).long()
    gmv = gm & valid
    rmv = rm & valid
    coupled = _coupled(P_sub) & valid
    gi = gmv.to(I32)
    stale_max, stale_sum, bins = _staleness(
        M, M.last_restart_k.index_select(0, gidx), gmv, ks)
    zero = torch.zeros((), dtype=F32, device=ts.device)
    drop_r = torch.where(rmv, workers, n).long()
    return MetricsCarry(
        # adds land at the clamped index: a padded lane adds an exact 0
        grad_steps=M.grad_steps.index_add(0, gidx, gi),
        mix_count=M.mix_count.index_add(0, gidx, coupled.to(I32)),
        last_restart_k=_set_at(M.last_restart_k, drop_r, ks),
        last_mix_t=_set_at(M.last_mix_t,
                           torch.where(coupled, workers, n).long(), ts),
        last_restart_t=_set_at(M.last_restart_t, drop_r, ts),
        busy_t=M.busy_t.index_add(0, gidx, torch.where(
            rmv, fin - M.last_restart_t.index_select(0, gidx), zero)),
        idle_t=M.idle_t.index_add(0, gidx, torch.where(rmv, ts - fin, zero)),
        stale_max=stale_max,
        stale_sum=stale_sum,
        stale_hist=M.stale_hist.index_add(0, bins, gi),
        comm_copies=M.comm_copies + copies,
    )


def _last_restart_prefix(hot: torch.Tensor, ks: torch.Tensor):
    """(cmax, prefix) over a block: ``cmax[e, w]`` the latest restart event
    of worker w up to event e (−1 if none in the block), ``prefix`` the
    exclusive version (up to e − 1)."""
    rk = torch.where(hot, ks[:, None], -1)
    cmax = torch.cummax(rk, dim=0).values
    prefix = torch.cat([torch.full_like(cmax[:1], -1), cmax[:-1]])
    return cmax, prefix


def block_metrics_update(M: MetricsCarry, workers: torch.Tensor,
                         gm: torch.Tensor, rm: torch.Tensor,
                         coupled: torch.Tensor, ts: torch.Tensor,
                         fin: torch.Tensor, ks: torch.Tensor,
                         copies: torch.Tensor) -> MetricsCarry:
    """Fold a whole block of E events into the carry in one pass.

    The generic block fold (arbitrary lane payloads): each worker's last
    restart is recovered with an exclusive ``cummax`` prefix over the
    block.  workers: (E, A) −1-padded; gm/rm/coupled: (E, A) bools; ts: (E,)
    float32 event clocks; fin: (E, A) float32; ks: (E,) int32 consecutive
    event indices; copies: (E,) int32.  Integer counters equal the
    sequential fold's; the float32 busy/idle sums add a block's terms in
    scatter order, so they are deterministic but not add-order-identical.
    """
    n = M.grad_steps.shape[0]
    E = workers.shape[0]
    valid = workers >= 0
    gmv, rmv, cpl = gm & valid, rm & valid, coupled & valid
    gidx = torch.where(valid, workers, 0).long()
    k0 = ks[0]
    ar = torch.arange(n, dtype=workers.dtype, device=workers.device)
    hot_r = ((workers[:, :, None] == ar) & rmv[:, :, None]).any(dim=1)
    cmax, prefix = _last_restart_prefix(hot_r, ks)
    in_blk = prefix >= k0
    pos = (prefix - k0).clamp(0, E - 1).long()
    eff_k = torch.where(in_blk, prefix, M.last_restart_k[None, :])
    eff_t = torch.where(in_blk, ts[pos], M.last_restart_t[None, :])
    lk = eff_k.gather(1, gidx)
    lt = eff_t.gather(1, gidx)
    s = ks[:, None] - lk - 1
    stale_max = torch.maximum(M.stale_max,
                              torch.where(gmv, s, -1).max().to(I32))
    stale_sum = M.stale_sum + torch.where(gmv, s, 0).sum().to(I32)
    gi = gmv.to(I32).reshape(-1)
    flat = gidx.reshape(-1)
    fin_k = cmax[-1]
    fin_in = fin_k >= k0
    hot_m = ((workers[:, :, None] == ar) & cpl[:, :, None]).any(dim=1)
    mix_k = torch.where(hot_m, ks[:, None], -1).max(dim=0).values
    zero = torch.zeros((), dtype=F32, device=ts.device)
    return MetricsCarry(
        grad_steps=M.grad_steps.index_add(0, flat, gi),
        mix_count=M.mix_count.index_add(0, flat, cpl.to(I32).reshape(-1)),
        last_restart_k=torch.where(fin_in, fin_k, M.last_restart_k),
        last_mix_t=torch.where(mix_k >= k0,
                               ts[(mix_k - k0).clamp(0, E - 1).long()],
                               M.last_mix_t),
        last_restart_t=torch.where(fin_in,
                                   ts[(fin_k - k0).clamp(0, E - 1).long()],
                                   M.last_restart_t),
        busy_t=M.busy_t.index_add(
            0, flat, torch.where(rmv, fin - lt, zero).reshape(-1)),
        idle_t=M.idle_t.index_add(
            0, flat, torch.where(rmv, ts[:, None] - fin, zero).reshape(-1)),
        stale_max=stale_max,
        stale_sum=stale_sum,
        stale_hist=M.stale_hist.index_add(0, _stale_bins(s).reshape(-1), gi),
        comm_copies=M.comm_copies + copies.sum().to(I32),
    )


def fused_metrics_fold(M: MetricsCarry, i_seq: torch.Tensor,
                       p_seq: torch.Tensor, t_raw: torch.Tensor,
                       t_ev: torch.Tensor, copies_pair: int,
                       k0: int = 0) -> MetricsCarry:
    """Drain-time fold of a fused run's streamed event identities.

    Every fused event has one gradient = restart worker, the finisher
    ``i_seq[e]``; the coupled set is {i, p} when a partner exists
    (``p_seq[e] >= 0``); the finisher is busy until its raw completion
    ``t_raw`` and waits for the lock until ``t_ev``; a pair event ships
    ``copies_pair`` copies.  So every accumulator is an O(E) scatter except
    the last-restart prefix, one (E, n) compare and ``cummax``.  The runner
    calls this once per run over the concatenated blocks.

    i_seq/p_seq: (E,) int finisher / partner (−1 when isolated);
    t_raw/t_ev: (E,) float32 raw and lock-shifted clocks; k0: the index of
    the first event.  The float32 busy/idle sums add in scatter order.
    """
    n = M.grad_steps.shape[0]
    E = i_seq.shape[0]
    dev = i_seq.device
    ks = k0 + torch.arange(E, dtype=I32, device=dev)
    i_l = i_seq.long()
    has = p_seq >= 0
    hot_r = i_l[:, None] == torch.arange(n, device=dev)
    cmax, prefix = _last_restart_prefix(hot_r, ks)
    in_run = prefix >= k0
    pos = (prefix - k0).clamp(0, E - 1).long()
    eff_k = torch.where(in_run, prefix, M.last_restart_k[None, :])
    eff_t = torch.where(in_run, t_ev[pos], M.last_restart_t[None, :])
    lk = eff_k.gather(1, i_l[:, None])[:, 0]
    lt = eff_t.gather(1, i_l[:, None])[:, 0]
    s = ks - lk - 1                                     # every event fires
    # both coupled lanes in one scatter; isolated events go to slot n
    midx = torch.cat([torch.where(has, i_l, n),
                      torch.where(has, p_seq.long(), n)])
    mix_k = torch.full((n + 1,), -1, dtype=I32, device=dev).scatter_reduce(
        0, midx, torch.cat([ks, ks]), reduce="amax")[:n]
    fin_k = cmax[-1]
    fin_in = fin_k >= k0
    ones = torch.ones(E, dtype=I32, device=dev)
    mix = torch.zeros(n + 1, dtype=I32, device=dev).index_add_(
        0, midx, torch.cat([ones, ones]))[:n]
    return MetricsCarry(
        grad_steps=M.grad_steps.index_add(0, i_l, ones),
        mix_count=M.mix_count + mix,
        last_restart_k=torch.where(fin_in, fin_k, M.last_restart_k),
        last_mix_t=torch.where(mix_k >= k0,
                               t_ev[(mix_k - k0).clamp(0, E - 1).long()],
                               M.last_mix_t),
        last_restart_t=torch.where(fin_in,
                                   t_ev[(fin_k - k0).clamp(0, E - 1).long()],
                                   M.last_restart_t),
        busy_t=M.busy_t.index_add(0, i_l, t_raw - lt),
        idle_t=M.idle_t.index_add(0, i_l, t_ev - t_raw),
        stale_max=torch.maximum(M.stale_max, s.max().to(I32)),
        stale_sum=M.stale_sum + s.sum().to(I32),
        stale_hist=M.stale_hist.index_add(0, _stale_bins(s), ones),
        comm_copies=M.comm_copies + (has.to(I32) * copies_pair).sum().to(I32),
    )


def metrics_summary(M: MetricsCarry, t_end: float,
                    n_minus_1_bound: bool = False) -> Dict[str, object]:
    """Drain the carry to the host (one fetch) and derive the report fields.

    A JSON-friendly dict: per-worker lists plus derived scalars -- mean
    utilization (busy / (busy + idle)), mean staleness, per-worker virtual
    age since the last mix.  With ``n_minus_1_bound`` (DSGD-AAU) it carries
    a ``staleness_bound`` sub-dict checking ``stale_max ≤ 2N − 4``.
    """
    host = MetricsCarry(*fetch(*M))
    n = int(host.grad_steps.shape[0])
    busy = np.asarray(host.busy_t, dtype=np.float64)
    idle = np.asarray(host.idle_t, dtype=np.float64)
    span = busy + idle
    util = np.divide(busy, span, out=np.zeros_like(busy), where=span > 0)
    grads_total = int(host.grad_steps.sum())
    stale_max = int(host.stale_max)
    out: Dict[str, object] = {
        "grad_steps": [int(v) for v in host.grad_steps],
        "mix_count": [int(v) for v in host.mix_count],
        "busy_t": [round(float(v), 6) for v in busy],
        "idle_t": [round(float(v), 6) for v in idle],
        "utilization": [round(float(v), 6) for v in util],
        "utilization_mean": float(util.mean()) if n else 0.0,
        "mix_age": [round(float(t_end) - float(v), 6)
                    for v in host.last_mix_t],
        "stale_max": stale_max,
        "stale_mean": (float(host.stale_sum) / grads_total
                       if grads_total else 0.0),
        "stale_hist": [int(v) for v in host.stale_hist],
        "comm_copies": int(host.comm_copies),
    }
    if n_minus_1_bound:
        bound = max(0, 2 * n - 4)
        out["staleness_bound"] = {
            "bound": bound,
            "edges_per_epoch_bound": max(0, n - 1),
            "observed_max": stale_max,
            "ok": bool(stale_max <= bound),
        }
    return out
