"""The plain reference of the simulator cells: the paper's schedules worked
out again from the benchmark's inputs, and eq. (5) applied to every
worker's state with the plain decoder of ``model.py``.

Schedules (arXiv:2306.06559):

- DSGD-AAU (Algorithms 1-3): every worker computes at its own pace; an
  iteration ends when the newest finisher has a finished graph neighbour
  in another component of the epoch's committed graph (Pathsearch grows a
  spanning forest, and the epoch ends when it spans all workers).  Every
  finished worker then averages with its finished neighbours by
  Metropolis weights, applies its gradient and restarts.
- Synchronous DSGD (eq. 2): every round, every worker steps and mixes with
  the Metropolis weights of the whole graph.

State, per worker j: parameters W_j, the snapshot S_j its running
computation started from, the push-sum weight y_j and its restart count
(which picks its next batch from its pool).  An iteration over the active
set a with mixing matrix P (|a| × |a|):
W_a ← Pᵀ (W_a − η ∇F(S_a)), S_a ← W_a, y_a ← Pᵀ y_a, count_a += 1.
"""
from __future__ import annotations

import heapq
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from portbench import inputs
from portbench.reference.model import Matmul, lane_losses


def metropolis(sub_adj: np.ndarray) -> np.ndarray:
    """P_ij = 1 / (1 + max(deg_i, deg_j)) on the edges, P_ii = 1 − Σ_j P_ij,
    degrees within the active set."""
    deg = sub_adj.sum(1)
    P = np.where(sub_adj, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])),
                 0.0)
    P[np.diag_indices_from(P)] = 1.0 - P.sum(1)
    return P


def aau_events(adj: np.ndarray, times, counts: np.ndarray
               ) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
    """DSGD-AAU's iterations from a fresh start (every worker starting its
    computation at time 0), as (time, active workers ascending, P).  ``times``
    gives ``duration(worker, k)`` of a worker's k-th computation;
    ``counts`` (n,) holds each worker's computations drawn so far and is
    advanced in place."""
    n = adj.shape[0]
    heap = []
    for i in range(n):
        heap.append((times.duration(i, int(counts[i])), i))
        counts[i] += 1
    heapq.heapify(heap)
    finished = np.zeros(n, dtype=bool)
    comp = np.arange(n)                 # component label per worker
    while True:
        t, i = heapq.heappop(heap)
        finished[i] = True
        nb = np.flatnonzero(adj[i] & finished)
        nb = nb[comp[nb] != comp[i]]
        if nb.size == 0:
            continue
        for j in nb:
            comp[comp == comp[j]] = comp[i]
        act = np.flatnonzero(finished)
        yield t, act, metropolis(adj[np.ix_(act, act)])
        for j in act:
            heapq.heappush(heap, (t + times.duration(j, int(counts[j])), j))
            counts[j] += 1
        finished[:] = False
        if (comp == comp[0]).all():
            comp = np.arange(n)


def sync_event(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A synchronous round: every worker, the whole graph's weights."""
    return np.arange(adj.shape[0]), metropolis(adj)


def call_events(algorithm: str, adj: np.ndarray, times, counts: np.ndarray,
                call: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The iterations of one ``run`` call of the program (its bound
    ``max_events`` or ``max_time``, events at or before it), which starts
    the event process afresh, as (active workers, P)."""
    if algorithm == "dsgd_sync":
        if "max_time" in call:
            raise ValueError("synchronous calls are bounded by max_events")
        return [sync_event(adj)] * call["max_events"]
    out = []
    for t, act, P in aau_events(adj, times, counts):
        if ("max_time" in call and t > call["max_time"]) or (
                "max_events" in call and len(out) >= call["max_events"]):
            break
        out.append((act, P))
    return out


def history_rows(sizes: List[int], eval_every: int) -> List[List[int]]:
    """[last event's index, workers active over the rows' events] of each
    row of a call's history: one every ``eval_every`` events (those
    events), and a last one at the call's end (all its events)."""
    rows = [[e, sum(sizes[e + 1 - eval_every:e + 1])]
            for e in range(eval_every - 1, len(sizes), eval_every)]
    return rows + [[len(sizes) - 1, sum(sizes)]]


class SimReplay:
    """Every worker's state and the mixing weights, held in the
    configuration's dtype as the configuration states it, each update
    computed in the reference's arithmetic (``mm.dtype``) and rounded
    once.

    W0: one replica {leaf: tensor}, which every worker starts from; pool:
    (n, pool, B, T) token batches; eval_tokens: (B_eval, T).  ``fault``
    plants one of the faults a run is checked against ("half_batch": the
    gradient of the first half of each batch; "no_exchange": every P the
    identity)."""

    def __init__(self, cfg: dict, W0: Dict[str, torch.Tensor], n: int,
                 pool: torch.Tensor, eval_tokens: torch.Tensor, mm: Matmul,
                 fault: Optional[str] = None):
        self.cfg, self.mm, self.fault, self.dt = cfg, mm, fault, mm.dtype
        state = inputs.dtype_of(cfg)
        self.W = {k: v.to(state).unsqueeze(0).expand(n, *v.shape).clone()
                  for k, v in W0.items()}
        self.S = {k: v.clone() for k, v in self.W.items()}
        self.y = torch.ones(n, dtype=state, device=pool.device)
        self.count = torch.zeros(n, dtype=torch.long, device=pool.device)
        self.pool, self.eval_tokens = pool, eval_tokens

    def step(self, workers: np.ndarray, P: np.ndarray, eta: float) -> None:
        dev = self.pool.device
        a = torch.as_tensor(workers, dtype=torch.long, device=dev)
        # the mixing weights in the configuration's dtype, as the state
        Pt = torch.as_tensor(P, device=dev).to(self.y.dtype).to(self.dt)
        if self.fault == "no_exchange":
            Pt = torch.eye(len(workers), dtype=self.dt, device=dev)
        batch = self.pool[a, self.count[a] % self.pool.shape[1]]
        if self.fault == "half_batch":
            batch = batch[:, :batch.shape[1] // 2]
        Sa = {k: s[a].requires_grad_() for k, s in self.S.items()}
        loss = lane_losses(Sa, batch, self.cfg, self.mm).sum()
        grads = torch.autograd.grad(loss, list(Sa.values()))
        with torch.no_grad():
            for (k, w), g in zip(self.W.items(), grads):
                new = torch.einsum("ab,a...->b...", Pt,
                                   w[a].to(self.dt) - eta * g.to(self.dt))
                w[a] = new.to(w.dtype)
                self.S[k][a] = w[a]
            self.y[a] = (Pt.T @ self.y[a].to(self.dt)).to(self.y.dtype)
            self.count[a] += 1

    @torch.no_grad()
    def eval_loss(self) -> float:
        """The eval loss of the network's de-biased average, mean_j W_j/y_j."""
        y = self.y.to(self.dt)
        avg = {k: (w.to(self.dt) / y.reshape((-1,) + (1,) * (w.dim() - 1))
                   ).mean(0)[None] for k, w in self.W.items()}
        return float(lane_losses(avg, self.eval_tokens[None], self.cfg,
                                 self.mm)[0])
