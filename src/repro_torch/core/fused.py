"""Fused event generation for single-edge schedulers (``mode="fused"``).

The port of the reference's ``repro/core/fused.py``.  For AD-PSGD and AGP
the event process is a pure recurrence over per-worker next-completion
times (the asynchronous-gossip clock model of Lian et al. 2018 / Assran &
Rabbat 2020), so it runs on the device beside the worker state:

    i   = argmin(times)                     # next finisher
    t   = lock-shift(times[i])              # AD-PSGD's atomic-average lock
    r   = neighbors[i][⌊pick·deg(i)⌋]       # uniform neighbor pick
    ... 2-lane sparse update on (W, S, y, ptr) ...
    times[i] = t + base[i] · factor         # next completion draw

Each event both *generates* itself from the device clock and *consumes*
itself through :func:`~repro_torch.core.aau.sparse_event_update`, the
sparse path's event update.  The host's work per block is the scheduler's
two vectorized draws (``fused_draws``: completion-time factors and
neighbor picks) and one copy of them to the device; per event it only
queues launches, never reads the device.  The reference compiles a block
into one ``lax.scan``; here it is a Python loop over the block's events.

The stream is the reference's own realization: the same draws, assigned in
the same device-decided order, the clock in float32.  Its event identities,
virtual times, communication and restart counters match the reference's
fused mode exactly (``tests/test_torch_modes.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.aau import Carry, sparse_event_update, to_device
from repro_torch.utils.tree import Params

# An isolated worker's event: lane 0 keeps its row (purely local gradient
# step), lane 1 is padding.
_P_SELF2 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=np.float32)
_LANE_SELF2 = np.array([True, False])


class FusedPairBlock:
    """The fused generate-and-consume block of one pair scheduler.

    ``spec`` is ``_SingleEdgeScheduler.fused_spec()``: the static constants
    of the event process (padded neighbor table, degrees, base compute
    times, lock interval, the scheduler's 2×2 payloads), moved to
    ``device`` once.  Calling the block advances the worker state and the
    event process through ``len(factors)`` events, in place.

    Every per-event scalar is a (1,)-shaped device tensor and every lookup
    an ``index_select``: indexing with a 0-d integer tensor would read it
    back to the host, one device sync per lookup.
    """

    def __init__(self, loss_fn: Callable, spec: Dict[str, object],
                 device: torch.device):
        def dev(x, dtype):
            return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)

        self.grad_fn = torch.func.grad(loss_fn)
        deg = np.asarray(spec["deg"])
        nbr_table = np.asarray(spec["nbr_table"])
        self.deg = dev(deg, torch.int64)
        self.width = nbr_table.shape[1]
        self.nbr_flat = dev(nbr_table.reshape(-1), torch.int64)
        self.base = dev(spec["base"], torch.float32)
        lock_dt = float(spec["lock_dt"])
        self.lock_dt = dev([lock_dt], torch.float32) if lock_dt else None
        self.P1 = dev(spec["P_first"], torch.float32)
        self.P2 = dev(spec["P_second"], torch.float32)
        self.lane1 = dev(spec["lane_first"], torch.bool)
        self.lane2 = dev(spec["lane_second"], torch.bool)
        self.P_self = dev(_P_SELF2, torch.float32)
        self.lane_self = dev(_LANE_SELF2, torch.bool)
        self.copies_pair = int(spec["copies_pair"])
        self.minus1 = dev([-1], torch.int64)
        # On a graph without isolated workers both lanes of every event are
        # valid, which the host knows for the whole run; otherwise the
        # update finds the valid lanes on the device.
        self.lanes = (torch.arange(2, device=device) if bool((deg > 0).all())
                      else None)

    def _event(self, W: Params, S: Params, y: torch.Tensor, ptr: torch.Tensor,
               pools: Params, times: torch.Tensor, lock_free: torch.Tensor,
               factor: torch.Tensor, pick: torch.Tensor, eta: torch.Tensor):
        """One generated event; returns the new ``lock_free`` and the
        event's identity ``(i, p, t_ev)``: finisher, partner (−1 when
        isolated) and lock-shifted clock, each (1,).  W, S, y, ptr and
        times are updated in place."""
        i = torch.argmin(times).reshape(1)
        t = times.index_select(0, i)
        d = self.deg.index_select(0, i)
        has_nbr = d > 0
        if self.lock_dt is not None:
            # serialized atomic averaging (isolated workers skip it)
            t_pair = torch.maximum(t, lock_free) + self.lock_dt
            t_ev = torch.where(has_nbr, t_pair, t)
            lock_free = torch.where(has_nbr, t_ev, lock_free)
        else:
            t_ev = t
        # ⌊pick·deg⌋ clamped: pick ∈ [0, 1) but float32 rounding at huge
        # degree could land exactly on deg
        slot = torch.minimum((pick * d.to(torch.float32)).to(torch.int64),
                             torch.clamp(d - 1, min=0))
        r = self.nbr_flat.index_select(0, i * self.width + slot)
        first = i < r
        pair = torch.where(first, torch.cat([i, r]), torch.cat([r, i]))
        workers = torch.where(has_nbr, pair, torch.cat([i, self.minus1]))
        P_sub = torch.where(has_nbr, torch.where(first, self.P1, self.P2),
                            self.P_self)
        lanes = torch.where(has_nbr,
                            torch.where(first, self.lane1, self.lane2),
                            self.lane_self)
        sparse_event_update(W, S, y, ptr, pools, self.grad_fn, workers, P_sub,
                            lanes, lanes, eta, self.lanes)
        times.index_copy_(0, i, t_ev + self.base.index_select(0, i) * factor)
        p = torch.where(has_nbr, r, self.minus1)
        return lock_free, i, p, t_ev

    def __call__(self, carry: Carry, pools: Params, times: torch.Tensor,
                 lock_free: torch.Tensor, comm: torch.Tensor,
                 factors: np.ndarray, picks: np.ndarray, etas: np.ndarray
                 ) -> Tuple[Carry, torch.Tensor, torch.Tensor,
                            Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Advance ``carry = (W, S, y, ptr)`` and the (n,) float32 clock
        ``times`` in place through one block of host draws (each (E,)).

        ``lock_free`` (1,) float32 is the lock-release clock and ``comm``
        (1,) int64 the running parameter-copy counter, both returned anew.
        Returns ``(carry, lock_free, comm, (t_seq, i_seq, p_seq))``: each
        event's lock-shifted clock, finisher and partner (−1 when
        isolated), (E,) each on the device.
        """
        W, S, y, ptr = carry
        xs = to_device(np.stack([factors, picks, etas]), torch.float32,
                       y.device)
        ts: List[torch.Tensor] = []
        iis: List[torch.Tensor] = []
        ps: List[torch.Tensor] = []
        for e in range(xs.shape[1]):
            lock_free, i, p, t_ev = self._event(
                W, S, y, ptr, pools, times, lock_free, xs[0, e], xs[1, e],
                xs[2, e])
            comm = comm + (p >= 0).to(comm.dtype) * self.copies_pair
            ts.append(t_ev)
            iis.append(i)
            ps.append(p)
        return ((W, S, y, ptr), lock_free, comm,
                (torch.cat(ts), torch.cat(iis), torch.cat(ps)))
