"""The port's update layer (``repro_torch.core.aau``) against the reference's.

One dense ``EventBatch``, one active-set ``SparseEventBatch`` and one
``BucketedSparseEventBatch`` (plus its merged conflict-free rows) from the
same scheduler go through both packages' block updates from the same W0,
pools and step sizes.  The parity target is the reference's default
(``use_kernel=False``) path; the port runs its kernels' plain versions on
CPU tensors.  W, S and y must agree within float32 tolerance (atol 2e-5,
rtol 1e-4: sums in another order), ``ptr`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aau as ref_aau
from repro.core import topology
from repro.core.baselines import make_scheduler
from repro.core.scheduler import (BucketedSparseEventBatch, EventBatch,
                                  SparseEventBatch, merge_event_groups)
from repro.core.straggler import StragglerModel
from repro.data.synthetic import ClassificationData
from repro.xp.builders import mlp2nn_loss as ref_loss
from repro_torch.core import aau
from repro_torch.xp.builders import mlp2nn_loss

N = 16
E = 24
POOL = 8
TOL = dict(atol=2e-5, rtol=1e-4)
DATA = ClassificationData(n_workers=N, d=8, n_classes=4, samples_per_worker=64,
                          seed=0)


def _events(alg, seed=0, **kw):
    g = topology.erdos_renyi(N, 0.3, seed=3)
    sm = StragglerModel(n=N, straggler_prob=0.2, slowdown=6.0, seed=seed)
    sched = make_scheduler(alg, g, sm, **kw)
    evs = []
    for ev in sched.events():
        evs.append(ev)
        if len(evs) == E:
            return sched, evs


def _state(seed=0):
    """W0 (all workers distinct, so mixing is visible), pools, eta base."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (8, 16), "b1": (16,), "w2": (16, 16), "b2": (16,),
              "w3": (16, 4), "b3": (4,)}
    W = {k: (rng.normal(size=(N,) + s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    bs = [[DATA.batch(w, s, batch_size=8) for s in range(POOL)]
          for w in range(N)]
    pools = {k: np.stack([np.stack([np.asarray(b[k]) for b in row])
                          for row in bs]) for k in ("x", "y")}
    return W, pools


class _Pair:
    """The same carry in both packages."""

    def __init__(self, W, pools):
        self.jW = {k: jnp.asarray(v) for k, v in W.items()}
        self.jS = dict(self.jW)
        self.jy = jnp.ones((N,), jnp.float32)
        self.jptr = jnp.zeros((N,), jnp.int32)
        self.jpools = {k: jnp.asarray(v) for k, v in pools.items()}
        self.tW = {k: torch.as_tensor(v) for k, v in W.items()}
        self.tS = {k: v.clone() for k, v in self.tW.items()}
        self.ty = torch.ones(N)
        self.tptr = torch.zeros(N, dtype=torch.int32)
        self.tpools = {k: torch.as_tensor(v) for k, v in pools.items()}

    def dense(self, batch, etas):
        (self.jW, self.jS, self.jy, self.jptr) = ref_aau.masked_gossip_scan(
            self.jW, self.jS, self.jy, self.jptr, self.jpools,
            jax.grad(ref_loss), jnp.asarray(batch.P),
            jnp.asarray(batch.grad_workers),
            jnp.asarray(batch.restart_workers),
            jnp.asarray(etas, jnp.float32))
        (self.tW, self.tS, self.ty, self.tptr) = aau.masked_gossip_scan(
            self.tW, self.tS, self.ty, self.tptr, self.tpools,
            torch.func.grad(mlp2nn_loss), batch.P, batch.grad_workers,
            batch.restart_workers, etas)

    def sparse(self, batch, etas):
        (self.jW, self.jS, self.jy, self.jptr) = ref_aau.sparse_gossip_scan(
            self.jW, self.jS, self.jy, self.jptr, self.jpools,
            jax.grad(ref_loss), jnp.asarray(batch.workers),
            jnp.asarray(batch.P_sub), jnp.asarray(batch.grad_workers),
            jnp.asarray(batch.restart_workers),
            jnp.asarray(etas, jnp.float32))
        (self.tW, self.tS, self.ty, self.tptr) = aau.sparse_gossip_scan(
            self.tW, self.tS, self.ty, self.tptr, self.tpools,
            torch.func.grad(mlp2nn_loss), batch.workers, batch.P_sub,
            batch.grad_workers, batch.restart_workers, etas)

    def check(self):
        for name, ja, ta in (("W", self.jW, self.tW), ("S", self.jS, self.tS)):
            for k in ja:
                np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                           err_msg=f"{name}[{k}]", **TOL)
        np.testing.assert_allclose(self.ty.numpy(), np.asarray(self.jy), **TOL)
        np.testing.assert_array_equal(self.tptr.numpy(), np.asarray(self.jptr))
        assert int(self.tptr.sum()) > 0  # the pools were really walked


def _etas(E_, base=0.2, decay=0.95):
    return base * decay ** np.arange(E_)


ALGS = [("dsgd_aau", {}), ("ad_psgd", {"seed": 1}),
        ("prague", {"seed": 2, "group_size": 4}), ("dsgd_sync", {})]


@pytest.mark.parametrize("alg,kw", ALGS, ids=[a for a, _ in ALGS])
def test_dense_block_matches_reference(alg, kw):
    _, evs = _events(alg, **kw)
    pair = _Pair(*_state())
    batch = EventBatch.from_events(evs).pad_to(E + 3)
    etas = _etas(E + 3)
    etas[E:] = 0.0
    pair.dense(batch, etas)
    pair.check()


@pytest.mark.parametrize("alg,kw", ALGS, ids=[a for a, _ in ALGS])
def test_sparse_block_matches_reference(alg, kw):
    sched, evs = _events(alg, **kw)
    pair = _Pair(*_state(1))
    batch = SparseEventBatch.from_events(
        evs, active_bound=sched.active_bound()).pad_to(E + 2)
    pair.sparse(batch, _etas(E + 2))
    pair.check()


@pytest.mark.parametrize("alg,kw", ALGS, ids=[a for a, _ in ALGS])
def test_bucketed_and_merged_blocks_match_reference(alg, kw):
    """The stream packed over a forced 4/8/16 ladder and replayed segment by
    segment in stream order, the narrow rung folded into merged rows with
    per-lane step sizes.  DSGD-AAU's clique sizes cross rungs."""
    _, evs = _events(alg, **kw)
    bucketed = BucketedSparseEventBatch.from_events(evs, buckets=(4, 8, 16))
    if alg == "dsgd_aau":
        assert len({b for b, _, _ in bucketed.segments()}) > 1
    pair = _Pair(*_state(2))
    merged_rows = 0
    for b, off, seg in bucketed.segment_batches():
        if bucketed.buckets[b] == 4 and seg.E > 1:
            merged, lane_off = merge_event_groups(seg, 3)
            merged_rows += merged.E
            pair.sparse(merged, 0.2 * 0.95 ** (off + lane_off))
        else:
            pair.sparse(seg, 0.2 * 0.95 ** (off + np.arange(seg.E)))
    if alg != "dsgd_sync":  # barrier events all sit on the widest rung
        assert merged_rows > 0
    pair.check()
