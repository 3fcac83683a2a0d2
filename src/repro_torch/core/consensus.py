"""Consensus matrices with Metropolis weights (paper Assumption 1).

Given the per-iteration active structure — for each worker j the subset of
neighbors N_j(k) it waits for — we build the time-varying consensus matrix

    P_ij(k) = 1 / (1 + max(p_i(k), p_j(k)))   if j in N_i(k)  (active edge)
    P_ii(k) = 1 - sum_{j != i} P_ij(k)
    P_ij(k) = 0                               otherwise

where p_i(k) = |active neighbors of i at k|.  These weights make P(k) doubly
stochastic for *any* symmetric active-edge set, which is what Theorem 1 needs
(products of doubly-stochastic matrices + bounded-connectivity ⇒ geometric
consensus, Lemmas 1–2).

Inactive workers have row/col = e_i (identity): they keep their parameters,
matching "w_j(k+1) = w_j(k) if j not in N(k)" (Alg. 1 line 7).
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


def metropolis_matrix(n: int, active_edges: Iterable[Edge]) -> np.ndarray:
    """Build the Metropolis consensus matrix for a set of symmetric active edges.

    ``active_edges`` are undirected pairs (i, j), i != j, each meaning workers
    i and j average with each other this iteration.
    """
    adj = np.zeros((n, n), dtype=bool)
    for i, j in active_edges:
        if i == j:
            raise ValueError("self edges are implicit; pass only i != j pairs")
        adj[i, j] = adj[j, i] = True
    deg = adj.sum(axis=1)  # p_i(k)
    P = np.zeros((n, n), dtype=np.float64)
    ii, jj = np.nonzero(adj)
    P[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(P, 1.0 - P.sum(axis=1))
    return P


def metropolis_submatrix(n: int, workers: np.ndarray,
                         sub_adj: np.ndarray) -> np.ndarray:
    """Active-set restriction of :func:`metropolis_matrix`, built at O(m·n).

    ``workers`` is the sorted (m,) global index set and ``sub_adj`` the (m, m)
    boolean active-edge adjacency *among those workers* (symmetric, zero
    diagonal).  Returns exactly ``metropolis_matrix(n, edges)[np.ix_(workers,
    workers)]`` — bit-identical, not merely close — without materializing the
    (n, n) matrix: off-diagonal weights depend only on active degrees, and the
    diagonal ``1 − Σ_j P_ij`` is summed over a scattered length-``n`` scratch
    row so the floating-point reduction tree matches the dense build's
    ``P.sum(axis=1)`` (numpy's pairwise summation is position-dependent;
    summing the compact row instead would drift in the last ulp).
    """
    m = len(workers)
    deg = sub_adj.sum(axis=1)
    P = np.zeros((m, m), dtype=np.float64)
    ii, jj = np.nonzero(sub_adj)
    P[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    scratch = np.zeros((m, n))
    scratch[np.arange(m)[:, None], np.asarray(workers)[None, :]] = P
    np.fill_diagonal(P, 1.0 - scratch.sum(axis=1))
    return P


def is_doubly_stochastic(P: np.ndarray, tol: float = 1e-9) -> bool:
    return (
        bool(np.all(P >= -tol))
        and bool(np.allclose(P.sum(axis=0), 1.0, atol=tol))
        and bool(np.allclose(P.sum(axis=1), 1.0, atol=tol))
    )


def consensus_product(mats: Sequence[np.ndarray]) -> np.ndarray:
    """Φ_{k:s} = P(s) P(s+1) ... P(k) (paper's left-to-right product)."""
    out = np.eye(mats[0].shape[0])
    for P in mats:
        out = out @ P
    return out


def spectral_gap(P: np.ndarray) -> float:
    """1 - |λ₂| of a doubly-stochastic matrix — mixing-speed diagnostic."""
    ev = np.sort(np.abs(np.linalg.eigvals(P)))[::-1]
    return float(1.0 - ev[1]) if len(ev) > 1 else 1.0


def beta_min_positive(mats: Sequence[np.ndarray]) -> float:
    """β: the smallest strictly-positive entry over all consensus matrices."""
    vals = []
    for P in mats:
        pos = P[P > 0]
        if pos.size:
            vals.append(pos.min())
    return float(min(vals)) if vals else 1.0


def contraction_to_uniform(Phi: np.ndarray) -> float:
    """max_ij |Φ_ij − 1/N|, the quantity bounded geometrically by Lemma 2."""
    n = Phi.shape[0]
    return float(np.max(np.abs(Phi - 1.0 / n)))
