"""Pathsearch (paper Algorithm 3): decentralized strongly-connected-graph search.

Across an *epoch*, workers opportunistically commit edges into a shared edge
set ``P`` (with vertex set ``V``) until the accumulated graph G' = (V, P) is
strongly connected with V = N; then both sets reset and a new epoch begins.
Within an epoch, one *iteration* ends whenever at least one new edge is
committed; every worker that has finished its local gradient by that moment
participates in the iteration's gossip-average with its finished neighbors.

Implementation note (documented deviation): the paper commits an edge (i, j)
when "(i,j) ∈ E ∖ P and (i ∉ V or j ∉ V)".  Taken literally this only ever
grows single-node-attached trees and can deadlock when two partial components
of V need to merge (no edge between them has an endpoint outside V).  We use
the equivalent-intent condition *"the edge connects two distinct components of
G' (unseen nodes count as their own component)"* — i.e. G' is grown as a
spanning forest until it becomes a single spanning tree.  This preserves the
paper's guarantees: epochs still terminate after at most N−1 committed edges
(the bound B ≤ N−1 used in Remark 4 and the staleness bound), and G' is
strongly connected with V = N at epoch end.
"""
from __future__ import annotations

import dataclasses
from typing import List, Set, Tuple

import numpy as np

from repro_torch.core.topology import Graph

Edge = Tuple[int, int]


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        return True


@dataclasses.dataclass
class PathSearchState:
    """Consensus sets (P, V) of the current epoch, shared by all workers.

    In a real deployment every worker holds a local copy kept in sync by ID
    gossip (paper Remark 4: O(2NB) IDs, negligible next to parameter traffic).
    The simulator keeps the consensus copy directly.
    """
    graph: Graph
    committed: Set[Edge] = dataclasses.field(default_factory=set)   # P
    vertices: Set[int] = dataclasses.field(default_factory=set)     # V
    epochs_completed: int = 0

    def __post_init__(self):
        self._uf = _UnionFind(self.graph.n)
        self._nbr_cache = None
        # component root per worker, mirroring _UnionFind.find: updated on
        # every successful union (rare — ≤ n−1 per epoch), so the hot
        # membership tests vectorize over it instead of chasing parents
        self._roots = np.arange(self.graph.n, dtype=np.int32)

    # ------------------------------------------------------------------
    def novel_edges(self, finished: Set[int]) -> List[Edge]:
        """Committable edges among currently-finished workers.

        An edge is committable iff it is a graph edge between two distinct
        components of G' (see module docstring).  The candidate pairs come
        from one vectorized adjacency-submatrix scan (this runs on *every*
        worker finish, and the finished set grows large between AAU events
        at paper scale — the scalar double loop it replaces was the
        event-generation ceiling for DSGD-AAU); the returned order is the
        double loop's row-major upper-triangular order, which ``commit``
        depends on for deterministic union-find evolution.
        """
        fin = sorted(finished)
        if len(fin) < 2:
            return []
        widx = np.asarray(fin, dtype=np.intp)
        sub = np.triu(self.graph.adj[np.ix_(widx, widx)], k=1)
        ai, bi = np.nonzero(sub)
        if not ai.size:
            return []
        roots = self._roots[widx]
        return [(fin[a], fin[b]) for a, b in zip(ai.tolist(), bi.tolist())
                if roots[a] != roots[b]]

    def novel_edges_incident(self, i: int, finished) -> List[Edge]:
        """Committable graph edges between the just-finished ``i`` and the
        rest of the finished set — the incremental form of
        :meth:`novel_edges`.  Between commits the component partition is
        frozen, so scanning only the newly finished worker's neighborhood
        accumulates, finish by finish, exactly the edge *set* a full
        :meth:`novel_edges` scan would return at event time (the list order
        differs, but :meth:`commit` yields the same components and vertex
        set for any order of the same edge set — only which spanning-tree
        edges get recorded in ``committed`` varies).  O(deg) per finish,
        which is what keeps DSGD-AAU event generation flat in n.

        ``finished`` is either a set of worker ids or an (n,) bool mask —
        the mask form lets the whole neighborhood filter vectorize.
        """
        nb = self.graph.neighbor_lists[i]
        if isinstance(finished, np.ndarray):
            sel = nb[finished[nb] & (self._roots[nb] != self._roots[i])]
            return [(i, j) if i < j else (j, i) for j in sel.tolist()]
        if self._nbr_cache is None:
            # plain-int view of the graph's cached neighbor arrays (python
            # ints hash/compare faster in the set-membership test below)
            self._nbr_cache = [a.tolist() for a in self.graph.neighbor_lists]
        ri = int(self._roots[i])
        roots = self._roots
        out: List[Edge] = []
        for j in self._nbr_cache[i]:
            if j in finished and roots[j] != ri:
                out.append((i, j) if i < j else (j, i))
        return out

    def commit(self, edges: List[Edge]) -> None:
        for i, j in edges:
            ra, rb = self._uf.find(i), self._uf.find(j)
            if ra != rb:
                self._uf.union(i, j)
                # mirror the merge into the flat roots array: one of ra/rb
                # survived as the combined component's root
                rn = self._uf.find(i)
                ro = rb if rn == ra else ra
                self._roots[self._roots == ro] = rn
                self.committed.add((min(i, j), max(i, j)))
                self.vertices.update((i, j))

    def epoch_complete(self) -> bool:
        """G' = (V, P) strongly connected with V = N?"""
        if len(self.vertices) != self.graph.n:
            return False
        root = self._uf.find(0)
        return all(self._uf.find(i) == root for i in range(self.graph.n))

    def reset_epoch(self) -> None:
        self.committed.clear()
        self.vertices.clear()
        self._uf = _UnionFind(self.graph.n)
        self._roots[:] = np.arange(self.graph.n, dtype=np.int32)
        self.epochs_completed += 1

    # -- diagnostics ----------------------------------------------------
    @property
    def num_components(self) -> int:
        return len({self._uf.find(i) for i in range(self.graph.n)})
