"""Communication topologies for decentralized learning.

A topology is a symmetric adjacency structure over ``n`` workers.  The paper
assumes a strongly-connected undirected graph G = (N, E) (Assumption 2 requires
the union over a window to be strongly connected; a static connected graph
trivially satisfies it).

All graphs are represented by a frozen ``Graph`` holding a boolean numpy
adjacency matrix (no self loops stored; neighbor sets implicitly include self,
matching the paper's N_j = {i | (i,j) in E} ∪ {j}).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import FrozenSet, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int
    adj: np.ndarray  # (n, n) bool, symmetric, zero diagonal

    def __post_init__(self):
        a = np.asarray(self.adj, dtype=bool)
        if a.shape != (self.n, self.n):
            raise ValueError(f"adjacency must be ({self.n},{self.n}), got {a.shape}")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(a)):
            raise ValueError("adjacency must have zero diagonal")
        object.__setattr__(self, "adj", a)

    # -- queries ---------------------------------------------------------
    def neighbors(self, j: int) -> np.ndarray:
        """Neighbor indices of worker j, excluding j itself."""
        return np.nonzero(self.adj[j])[0]

    @functools.cached_property
    def neighbor_lists(self) -> Tuple[np.ndarray, ...]:
        """Per-worker neighbor index arrays, scanned from ``adj`` once.

        The event-generation hot loops (schedulers, Pathsearch) index this
        per event; recomputing ``neighbors(j)`` there would rescan an
        adjacency row each time.
        """
        return tuple(np.nonzero(self.adj[j])[0] for j in range(self.n))

    def degree(self, j: int) -> int:
        return int(self.adj[j].sum())

    @property
    def edges(self) -> Tuple[Tuple[int, int], ...]:
        iu = np.triu_indices(self.n, k=1)
        mask = self.adj[iu]
        return tuple((int(i), int(j)) for i, j in zip(iu[0][mask], iu[1][mask]))

    def is_connected(self) -> bool:
        return is_strongly_connected(self.adj)

    def edge_set(self) -> FrozenSet[Tuple[int, int]]:
        return frozenset(self.edges)


def is_strongly_connected(adj: np.ndarray) -> bool:
    """BFS reachability check on a symmetric adjacency matrix."""
    n = adj.shape[0]
    if n == 0:
        return True
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        u = stack.pop()
        for v in np.nonzero(adj[u])[0]:
            if not seen[v]:
                seen[v] = True
                stack.append(int(v))
    return bool(seen.all())


# -- constructors ---------------------------------------------------------

def ring(n: int) -> Graph:
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    if n == 2:
        adj = np.array([[False, True], [True, False]])
    return Graph(n, adj)


def fully_connected(n: int) -> Graph:
    adj = ~np.eye(n, dtype=bool)
    return Graph(n, adj)


def torus(rows: int, cols: int) -> Graph:
    """2-D torus: each worker connects to 4 grid neighbors (wrap-around)."""
    n = rows * cols
    adj = np.zeros((n, n), dtype=bool)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            u = idx(r, c)
            for v in (idx(r + 1, c), idx(r, c + 1)):
                if u != v:
                    adj[u, v] = adj[v, u] = True
    return Graph(n, adj)


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """Random connected graph: ER(n, p) resampled/augmented until connected.

    This mirrors the paper's "randomly generate a connected graph".
    """
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1)
    adj = adj | adj.T
    # Guarantee connectivity by adding a random Hamiltonian cycle's edges
    # where needed (keeps the graph random but connected, as in the paper).
    if not is_strongly_connected(adj):
        perm = rng.permutation(n)
        for a, b in zip(perm, np.roll(perm, 1)):
            adj[a, b] = adj[b, a] = True
        np.fill_diagonal(adj, False)
    return Graph(n, adj)


def multipod(n_per_pod: int, n_pods: int, inter_pod_edges: int = 2,
             intra: str = "torus", seed: int = 0) -> Graph:
    """Hierarchical pod topology: dense intra-pod (ICI), sparse inter-pod (DCI).

    Each pod is an intra-pod graph; ``inter_pod_edges`` distinct worker pairs
    bridge each pair of adjacent pods (ring of pods).  This is the graph used
    for the multi-pod dry-run: inter-pod gossip traffic is limited to the few
    bridge edges, unlike all-reduce which crosses DCI on every step.
    """
    n = n_per_pod * n_pods
    adj = np.zeros((n, n), dtype=bool)
    rng = np.random.default_rng(seed)
    for p in range(n_pods):
        off = p * n_per_pod
        if intra == "torus":
            rows = int(np.floor(np.sqrt(n_per_pod)))
            while n_per_pod % rows:
                rows -= 1
            sub = torus(rows, n_per_pod // rows).adj
        elif intra == "full":
            sub = fully_connected(n_per_pod).adj
        else:
            sub = ring(n_per_pod).adj
        adj[off:off + n_per_pod, off:off + n_per_pod] = sub
    for p in range(n_pods):
        q = (p + 1) % n_pods
        if q == p:
            continue
        picks_p = rng.choice(n_per_pod, size=inter_pod_edges, replace=False)
        picks_q = rng.choice(n_per_pod, size=inter_pod_edges, replace=False)
        for a, b in zip(picks_p, picks_q):
            u, v = p * n_per_pod + int(a), q * n_per_pod + int(b)
            adj[u, v] = adj[v, u] = True
    np.fill_diagonal(adj, False)
    return Graph(n, adj)


REGISTRY = {
    "ring": ring,
    "full": fully_connected,
    "torus": torus,
    "erdos_renyi": erdos_renyi,
    "multipod": multipod,
}
