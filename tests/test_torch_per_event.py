"""The port's ``mode="per_event"`` against the reference's, on the CPU.

Both packages build the same cell from one ``ExperimentSpec`` and start
from the same W0 (the reference's ``mlp2nn_init()(PRNGKey(0))`` carried into
the port), so both replay the same event stream and draw the same batches
on the host.  The port's step is the reference's default (``use_kernel=
False``) branch: the elementwise gradient step, then ``gossip_mix_dense``.
W, S and y must agree within 1e-5 (float32 sums in another order over 40
events), the history's counters, virtual times and copies exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.xp.builders import build_trainer as ref_build_trainer
from repro.xp.builders import mlp2nn_init as ref_init
from repro.xp.spec import ExperimentSpec as RefSpec
from repro_torch.xp import ExperimentSpec, build_trainer, params_from_numpy

N = 16
EVENTS = 40


def _spec_kw(mode, **kw):
    base = dict(scales=(N,), seeds=(0,), mode=mode, max_time=None,
                max_events=EVENTS, eta0=0.2, eta_decay=0.999)
    base.update(kw)
    return base


def _w0():
    return params_from_numpy(jax.device_get(ref_init()(jax.random.PRNGKey(0))),
                             device="cpu")


def _port(alg, mode, batch_pool=None, **kw):
    return build_trainer(ExperimentSpec(**_spec_kw(mode, **kw)), alg, N, 0,
                         device="cpu", batch_pool=batch_pool,
                         init_params=_w0())


def _state_close(a, b, tol):
    """W, S and y of two trainers (either package) within ``tol``."""
    for name, x, y in (("W", a.W, b.W), ("S", a.S, b.S)):
        for k in x:
            np.testing.assert_allclose(np.asarray(x[k]), np.asarray(y[k]),
                                       atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(np.asarray(a.y), np.asarray(b.y), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("alg", ["dsgd_aau", "ad_psgd", "agp"])
def test_per_event_matches_reference(alg):
    ref = ref_build_trainer(RefSpec(**_spec_kw("per_event")), alg, N, 0)
    port = _port(alg, "per_event")
    assert port.mode == ref.mode == "per_event"
    res_ref = ref.run(max_events=EVENTS, eval_every=10)
    res = port.run(max_events=EVENTS, eval_every=10)
    _state_close(port, ref, 1e-5)
    assert (res.total_events, res.total_time, res.total_comm_copies) == (
        res_ref.total_events, res_ref.total_time, res_ref.total_comm_copies)
    assert len(res.history) == len(res_ref.history) == EVENTS // 10 + 1
    for a, b in zip(res_ref.history, res.history):
        assert (b.k, b.time, b.comm_param_copies) == (a.k, a.time,
                                                      a.comm_param_copies)
        assert b.n_active_mean == pytest.approx(a.n_active_mean)
        assert b.loss == pytest.approx(a.loss, abs=1e-5)
        assert b.metric == pytest.approx(a.metric, abs=1e-5)
    np.testing.assert_array_equal(port._draw_count, ref._draw_count)
    assert res.history[-1].loss < res.history[0].loss


@pytest.mark.parametrize("alg", ["dsgd_aau", "agp"])
def test_per_event_matches_scan(alg):
    """Two routes to eq. (5) in the port: the unfolded step with
    gossip_mix, and the dense scan's masked_gossip over a pool that does
    not wrap (block size 7 does not divide the eval grid)."""
    per = _port(alg, "per_event")
    res_per = per.run(max_events=EVENTS, eval_every=10)
    scan = _port(alg, "scan", batch_pool=48, block_size=7)
    res_scan = scan.run(max_events=EVENTS, eval_every=10)
    _state_close(per, scan, 1e-5)
    assert len(res_per.history) == len(res_scan.history)
    for a, b in zip(res_per.history, res_scan.history):
        assert (b.k, b.time, b.comm_param_copies) == (a.k, a.time,
                                                      a.comm_param_copies)
        assert b.loss == pytest.approx(a.loss, abs=1e-5)
    # the scan's restart counters are the per-event batch draws past the
    # first one each worker made
    np.testing.assert_array_equal(scan._ptr.numpy(), per._draw_count - 1)


def test_per_event_warmup_leaves_state_unchanged():
    tr = _port("dsgd_aau", "per_event")
    W0 = {k: v.clone() for k, v in tr.W.items()}
    S0 = {k: v.clone() for k, v in tr.S.items()}
    y0 = tr.y.clone()
    tr.warmup()
    for k in W0:
        assert torch.equal(tr.W[k], W0[k]) and torch.equal(tr.S[k], S0[k])
    assert torch.equal(tr.y, y0)
    # the first batches were drawn, nothing more
    np.testing.assert_array_equal(tr._draw_count, np.ones(N))
    res_warm = tr.run(max_events=20, eval_every=10)
    res = _port("dsgd_aau", "per_event").run(max_events=20, eval_every=10)
    assert [p.loss for p in res_warm.history] == [p.loss for p in res.history]


def test_per_event_max_time_bound():
    kw = dict(max_time=20.0, max_events=None)
    ref = ref_build_trainer(RefSpec(**_spec_kw("per_event", **kw)),
                            "dsgd_aau", N, 0)
    res_ref = ref.run(max_time=20.0, eval_every=10)
    port = build_trainer(ExperimentSpec(**_spec_kw("per_event", **kw)),
                         "dsgd_aau", N, 0, device="cpu", init_params=_w0())
    res = port.run(max_time=20.0, eval_every=10)
    assert res.total_events == res_ref.total_events
    assert 0 < res.total_events < 1000
    assert res.total_time <= 20.0 and res.total_time == res_ref.total_time
    assert res.final_loss == pytest.approx(res_ref.final_loss, abs=1e-5)
