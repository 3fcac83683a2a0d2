"""The port's ``mode="fused"`` against the reference's, on the CPU.

The fused stream is generated on the device from the scheduler's block
draws; the port replays the reference's realization, so it is held to it
exactly: each event's finisher, partner and clock, the virtual times, the
communication copies and the restart counters.  The state goes through the
same 2-lane active-set updates and agrees within 1e-5 (float32 sums in
another order).  Inputs are the same NumPy draws in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as ref_topology
from repro.core.baselines import make_scheduler as ref_make_scheduler
from repro.core.fused import build_fused_pair_scan
from repro.core.straggler import StragglerModel as RefStraggler
from repro.data.synthetic import ClassificationData
from repro.xp.builders import build_trainer as ref_build_trainer
from repro.xp.builders import mlp2nn_init as ref_init
from repro.xp.spec import ExperimentSpec as RefSpec
from repro_torch.core import topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.fused import FusedPairBlock
from repro_torch.core.runner import DecentralizedTrainer
from repro_torch.core.straggler import StragglerModel
from repro_torch.scenarios import get_scenario
from repro_torch.xp import ExperimentSpec, build_trainer, params_from_numpy
from repro_torch.xp.builders import build_graph, mlp2nn_init, mlp2nn_loss

N = 16
EVENTS = 96
SPEC_KW = dict(scales=(N,), seeds=(0,), mode="fused", max_time=None,
               max_events=EVENTS, eta0=0.2, eta_decay=0.999, block_size=16)


def _port(alg, seed=0):
    w0 = jax.device_get(ref_init()(jax.random.PRNGKey(seed)))
    return build_trainer(ExperimentSpec(**SPEC_KW), alg, N, seed,
                         device="cpu", batch_pool=EVENTS,
                         init_params=params_from_numpy(w0, device="cpu"))


@pytest.mark.parametrize("alg", ["ad_psgd", "agp"])
def test_fused_matches_reference(alg):
    ref = ref_build_trainer(RefSpec(**SPEC_KW), alg, N, 0, batch_pool=EVENTS)
    port = _port(alg)
    assert port.mode == ref.mode == "fused"
    res_ref = ref.run(max_events=EVENTS, eval_every=24)
    res = port.run(max_events=EVENTS, eval_every=24)
    assert (res.total_events, res.total_time, res.total_comm_copies) == (
        res_ref.total_events, res_ref.total_time, res_ref.total_comm_copies)
    np.testing.assert_array_equal(port._ptr.numpy(), np.asarray(ref._ptr))
    assert len(res.history) == len(res_ref.history) == EVENTS // 24
    for a, b in zip(res_ref.history, res.history):
        assert (b.k, b.time, b.comm_param_copies, b.n_active_mean) == (
            a.k, a.time, a.comm_param_copies, a.n_active_mean)
        assert b.loss == pytest.approx(a.loss, abs=1e-5)
    for name, x, y in (("W", port.W, ref.W), ("S", port.S, ref.S)):
        for k in x:
            np.testing.assert_allclose(x[k].numpy(), np.asarray(y[k]),
                                       atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(port.y.numpy(), np.asarray(ref.y), atol=1e-5,
                               rtol=0)
    assert res.final_loss < res.history[0].loss


# -- block level: event identities, connected and isolated graphs -----------

D_IN, N_CLS, POOL = 16, 4, 32
DATA = ClassificationData(n_workers=N, d=D_IN, n_classes=N_CLS,
                          samples_per_worker=64, seed=0)


def _jax_loss(params, batch):
    logp = jax.nn.log_softmax(batch["x"] @ params["w"])
    return -jnp.mean(jnp.take_along_axis(logp, batch["y"][:, None], axis=1))


def _torch_loss(params, batch):
    logp = torch.log_softmax(batch["x"] @ params["w"], dim=-1)
    return -logp.gather(1, batch["y"].long()[:, None]).mean()


def _adjacency(isolated: bool):
    """A ring over all workers, or over all but the last, which is then
    isolated (it fires purely local events)."""
    m = N - 1 if isolated else N
    adj = np.zeros((N, N), dtype=bool)
    for i in range(m):
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
    return adj


@pytest.mark.parametrize("alg", ["ad_psgd", "agp"])
@pytest.mark.parametrize("isolated", [False, True])
def test_fused_block_event_identities_match_reference(alg, isolated):
    adj = _adjacency(isolated)
    seed = {"ad_psgd": 1, "agp": 3}[alg]
    ref_sched = ref_make_scheduler(
        alg, ref_topology.Graph(N, adj),
        RefStraggler(n=N, straggler_prob=0.2, slowdown=6.0, seed=0), seed=seed)
    sched = make_scheduler(alg, topology.Graph(N, adj),
                           StragglerModel(n=N, straggler_prob=0.2,
                                          slowdown=6.0, seed=0), seed=seed)
    spec = sched.fused_spec()
    assert int((spec["deg"] == 0).sum()) == int(isolated)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(N, D_IN, N_CLS)) * 0.1).astype(np.float32)
    bs = [[DATA.batch(i, s, batch_size=8) for s in range(POOL)]
          for i in range(N)]
    pools = {k: np.stack([np.stack([np.asarray(b[k]) for b in row])
                          for row in bs]) for k in ("x", "y")}
    times0 = ref_sched.fused_initial_times()
    np.testing.assert_array_equal(times0, sched.fused_initial_times())

    jblock = build_fused_pair_scan(_jax_loss, ref_sched.fused_spec(),
                                   telemetry=True)
    jW = {"w": jnp.asarray(w)}
    # the block donates its carry: S must not share W's buffers
    jcarry = (jW, jax.tree.map(jnp.array, jW), jnp.ones((N,), jnp.float32),
              jnp.zeros((N,), jnp.int32))
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    jclock = (jnp.asarray(times0), jnp.float32(0.0))
    jcomm = jnp.int32(0)
    tblock = FusedPairBlock(_torch_loss, spec, torch.device("cpu"))
    assert (tblock.lanes is None) == isolated
    tcarry = ({"w": torch.tensor(w)}, {"w": torch.tensor(w)}, torch.ones(N),
              torch.zeros(N, dtype=torch.int32))
    tpools = {k: torch.as_tensor(v) for k, v in pools.items()}
    times, lock_free = torch.tensor(times0), torch.zeros(1)
    tcomm = torch.zeros(1, dtype=torch.int64)
    seen_isolated = 0
    for blk in range(4):
        factors, picks = ref_sched.fused_draws(16)
        sched.fused_draws(16)   # keep the port's scheduler in step
        etas = (0.2 * 0.99 ** (16 * blk + np.arange(16))).astype(np.float32)
        (*jstate, jt, jl, jcomm), (t_ev, i, p, _) = jblock(
            *jcarry, jpools, *jclock, jcomm, jnp.asarray(factors),
            jnp.asarray(picks), jnp.asarray(etas))
        jcarry, jclock = tuple(jstate), (jt, jl)
        tcarry, lock_free, tcomm, (tt, ti, tp) = tblock(
            tcarry, tpools, times, lock_free, tcomm, factors, picks, etas)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(p))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(t_ev))
        seen_isolated += int((tp == -1).sum())
    assert (seen_isolated > 0) == isolated
    np.testing.assert_array_equal(times.numpy(), np.asarray(jclock[0]))
    assert float(lock_free[0]) == float(jclock[1])
    assert int(tcomm[0]) == int(jcomm)
    np.testing.assert_array_equal(tcarry[3].numpy(), np.asarray(jcarry[3]))
    assert int(tcarry[3].sum()) == 64   # one finisher restart per event
    for t, j in zip(tcarry[:2], jcarry[:2]):
        np.testing.assert_allclose(t["w"].numpy(), np.asarray(j["w"]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcarry[2].numpy(), np.asarray(jcarry[2]),
                               atol=1e-5, rtol=0)


# -- the port's own guarantees ----------------------------------------------

@pytest.mark.parametrize("alg", ["ad_psgd", "agp"])
def test_fused_deterministic_per_seed(alg):
    t1, t2 = _port(alg), _port(alg)
    r1 = t1.run(max_events=48, eval_every=24)
    r2 = t2.run(max_events=48, eval_every=24)
    for k in t1.W:
        assert torch.equal(t1.W[k], t2.W[k])
    assert torch.equal(t1.y, t2.y)
    assert r1.total_time == r2.total_time
    assert r1.total_comm_copies == r2.total_comm_copies
    assert [p.loss for p in r1.history] == [p.loss for p in r2.history]


def test_fused_warmup_does_not_shift_the_stream():
    t1, t2 = _port("ad_psgd"), _port("ad_psgd")
    W0 = {k: v.clone() for k, v in t2.W.items()}
    t2.warmup(max_events=48)
    for k in W0:
        assert torch.equal(t2.W[k], W0[k])
    r1 = t1.run(max_events=48, eval_every=24)
    r2 = t2.run(max_events=48, eval_every=24)
    for k in t1.W:
        assert torch.equal(t1.W[k], t2.W[k])
    assert r1.total_time == r2.total_time


def test_fused_exact_event_accounting():
    """A connected graph: every event is a pair exchange, so comm and
    restart totals are exact."""
    tr = _port("ad_psgd")
    assert all(len(nb) for nb in tr.scheduler.graph.neighbor_lists)
    copies_pair = int(tr.scheduler.fused_spec()["copies_pair"])
    res = tr.run(max_events=EVENTS, eval_every=24)
    assert res.total_events == EVENTS
    assert res.total_comm_copies == EVENTS * copies_pair
    assert int(tr._ptr.sum()) == EVENTS
    assert res.history[-1].n_active_mean == pytest.approx(2.0)


@pytest.mark.parametrize("alg,scenario", [("dsgd_aau", "paper_default"),
                                          ("prague", "paper_default"),
                                          ("ad_psgd", "diurnal")])
def test_fused_rejects_what_it_cannot_generate(alg, scenario):
    """Clique schedulers have no fused generator; the diurnal sampler's
    factors depend on the worker and the clock, so they cannot be drawn
    flat ahead of the block."""
    sched = make_scheduler(alg, build_graph("ring", 8),
                           get_scenario(scenario, n=8, seed=0))
    with pytest.raises(ValueError, match="single-edge scheduler"):
        DecentralizedTrainer(sched, mlp2nn_loss, mlp2nn_init(),
                             lambda w, s: None, {}, mode="fused",
                             device="cpu")


def test_fused_runs_are_bounded_by_events():
    tr = _port("agp")
    with pytest.raises(ValueError, match="max_events"):
        tr.run(max_time=5.0)
    with pytest.raises(ValueError, match="max_time"):
        tr.run(max_events=16, max_time=5.0)
