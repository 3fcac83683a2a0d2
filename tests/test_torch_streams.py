"""The port's copied host modules emit the reference's event streams bit for bit.

Schedulers, topologies and scenarios are NumPy code that the port carries
as its own copy (it imports nothing of the JAX package).  Built from the
same arguments, both copies must consume their RNGs in the same order and
emit identical events: workers, consensus submatrices, lane masks, virtual
times and copy counts, compared with ``np.array_equal``.
"""
import numpy as np
import pytest

from repro.core import consensus as ref_consensus
from repro.core import topology as ref_topology
from repro.core.baselines import make_scheduler as ref_make_scheduler
from repro.core.scheduler import (BucketedSparseEventBatch as RefBucketed,
                                  EventBatch as RefEventBatch)
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.core import consensus, topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.scheduler import BucketedSparseEventBatch, EventBatch
from repro_torch.scenarios import get_scenario

ALGS = ("dsgd_aau", "dsgd_sync", "ad_psgd", "prague", "agp")
SCHED_KW = {"ad_psgd": {"seed": 1}, "prague": {"seed": 2, "group_size": 4},
            "agp": {"seed": 3}}
BATCH_FIELDS = ("workers", "n_workers", "P_sub", "grad_workers",
                "restart_workers", "times", "param_copies_sent", "edges",
                "n_edges", "finish")


def _pair(alg, n, scenario="paper_default", seed=0):
    p = max(0.15, 4.0 / n)
    ref = ref_make_scheduler(
        alg, ref_topology.erdos_renyi(n, p, seed=1),
        ref_get_scenario(scenario, n=n, seed=seed), **SCHED_KW.get(alg, {}))
    port = make_scheduler(
        alg, topology.erdos_renyi(n, p, seed=1),
        get_scenario(scenario, n=n, seed=seed), **SCHED_KW.get(alg, {}))
    return ref, port


def _assert_batches_equal(a, b):
    assert a.k0 == b.k0
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _assert_chunks_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(b, BucketedSparseEventBatch):
        assert a.k0 == b.k0 and a.buckets == b.buckets
        assert np.array_equal(a.event_bucket, b.event_bucket)
        assert np.array_equal(a.positions, b.positions)
        for x, y in zip(a.batches, b.batches):
            assert (x is None) == (y is None)
            if y is not None:
                _assert_batches_equal(x, y)
    else:
        _assert_batches_equal(a, b)


def test_topology_and_consensus_copies_agree():
    for n in (16, 64):
        g_ref = ref_topology.erdos_renyi(n, 0.2, seed=5)
        g = topology.erdos_renyi(n, 0.2, seed=5)
        assert np.array_equal(g_ref.adj, g.adj)
        assert g_ref.edges == g.edges
        edges = g.edges[:n // 2]
        assert np.array_equal(ref_consensus.metropolis_matrix(n, edges),
                              consensus.metropolis_matrix(n, edges))


@pytest.mark.parametrize("alg", ALGS)
def test_object_streams_match_at_n16(alg):
    ref, port = _pair(alg, 16)
    assert ref.active_buckets() == port.active_buckets()
    assert ref.edge_bound() == port.edge_bound()
    ref_evs, evs = [], []
    for a, b in zip(ref.events(), port.events()):
        assert (a.k, a.time, a.param_copies_sent) == (b.k, b.time,
                                                      b.param_copies_sent)
        for f in ("workers", "P_sub", "grad_lanes", "restart_lanes", "edges"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        ref_evs.append(a)
        evs.append(b)
        if len(evs) == 48:
            break
    # the dense packing the scan path consumes
    A = RefEventBatch.from_events(ref_evs, edge_bound=ref.edge_bound())
    B = EventBatch.from_events(evs, edge_bound=port.edge_bound())
    for f in ("times", "P", "grad_workers", "restart_workers",
              "param_copies_sent", "edges", "n_edges", "finish"):
        assert np.array_equal(getattr(A, f), getattr(B, f)), f


@pytest.mark.parametrize("alg", ALGS)
def test_packed_streams_match_at_n16(alg):
    ref, port = _pair(alg, 16)
    rs, ps = ref.packed_stream(native=True), port.packed_stream(native=True)
    for want in (7, 16, 1, 24):
        _assert_chunks_equal(rs.next_chunk(want), ps.next_chunk(want))


@pytest.mark.parametrize("n,chunks", [(64, (32, 32, 17, 32)), (256, (32, 32))])
def test_dsgd_aau_bucketed_streams_match(n, chunks):
    ref, port = _pair("dsgd_aau", n)
    assert port.active_buckets() == ref.active_buckets()
    assert len(port.active_buckets()) > 1
    rs, ps = ref.packed_stream(native=True), port.packed_stream(native=True)
    for want in chunks:
        a, b = rs.next_chunk(want), ps.next_chunk(want)
        assert isinstance(b, BucketedSparseEventBatch)
        assert isinstance(a, RefBucketed)
        _assert_chunks_equal(a, b)
        for (ba, oa, sa), (bb, ob, sb) in zip(a.segment_batches(),
                                              b.segment_batches()):
            assert (ba, oa) == (bb, ob)
            _assert_batches_equal(sa, sb)
        assert np.array_equal(a.stream_times(), b.stream_times())
        assert np.array_equal(a.stream_copies(), b.stream_copies())


@pytest.mark.parametrize("scenario", ["heavy_tail", "bimodal"])
def test_scenarios_drive_identical_streams(scenario):
    ref, port = _pair("dsgd_aau", 16, scenario=scenario, seed=3)
    rs, ps = ref.packed_stream(native=True), port.packed_stream(native=True)
    for want in (16, 16):
        _assert_chunks_equal(rs.next_chunk(want), ps.next_chunk(want))
