"""The port's trainer against the reference's, cell by cell, on the CPU.

Both packages build the same experiment cell from one ``ExperimentSpec``
(scheduler, scenario, topology, data and pools are the same NumPy draws) and
start from the same W0: the reference's ``mlp2nn_init()(PRNGKey(seed))``
carried into the port with ``params_from_numpy``.  The recorded histories
must agree: losses within 1e-4 (float32 sums in another order, compounded
over 96 events), and the event counters, virtual times and communication
copies exactly -- they come from the shared event stream.
"""
import jax
import numpy as np
import pytest
import torch

from repro.xp.builders import build_trainer as ref_build_trainer
from repro.xp.builders import mlp2nn_init as ref_init
from repro.xp.spec import ExperimentSpec as RefSpec
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DecentralizedTrainer, choose_mode
from repro_torch.scenarios import get_scenario
from repro_torch.xp import ExperimentSpec, build_trainer, params_from_numpy
from repro_torch.xp.builders import build_graph, mlp2nn_init, mlp2nn_loss

EVENTS = 96


def _run_both(alg, n, mode, eval_every, seed=0, dtype="float32"):
    kw = dict(scales=(n,), seeds=(seed,), mode=mode, max_time=None,
              max_events=EVENTS, eta0=0.2, eta_decay=0.999, dtype=dtype)
    ref = ref_build_trainer(RefSpec(**kw), alg, n, seed)
    w0 = jax.device_get(ref_init()(jax.random.PRNGKey(seed)))
    port = build_trainer(ExperimentSpec(**kw), alg, n, seed,
                         device="cpu",
                         init_params=params_from_numpy(w0, device="cpu"))
    assert port.mode == ref.mode
    res_ref = ref.run(max_events=EVENTS, eval_every=eval_every)
    res = port.run(max_events=EVENTS, eval_every=eval_every)
    return ref, res_ref, port, res


def _assert_same_run(res_ref, res, loss_tol=1e-4):
    assert res.total_events == res_ref.total_events == EVENTS
    assert res.total_time == res_ref.total_time
    assert res.total_comm_copies == res_ref.total_comm_copies
    assert res.param_count == res_ref.param_count == 85002
    assert len(res.history) == len(res_ref.history)
    for a, b in zip(res_ref.history, res.history):
        assert (b.k, b.time, b.comm_param_copies) == (a.k, a.time,
                                                      a.comm_param_copies)
        assert b.n_active_mean == pytest.approx(a.n_active_mean)
        assert b.loss == pytest.approx(a.loss, abs=loss_tol)
        if loss_tol <= 1e-4:
            assert b.metric == pytest.approx(a.metric, abs=1e-4)
    assert res.history[-1].loss < res.history[0].loss


@pytest.mark.parametrize("alg", ["dsgd_aau", "dsgd_sync", "ad_psgd",
                                 "prague", "agp"])
def test_dense_scan_matches_reference_at_n16(alg):
    ref, res_ref, port, res = _run_both(alg, 16, "scan", eval_every=32)
    assert port.mode == "scan"
    _assert_same_run(res_ref, res)
    np.testing.assert_array_equal(port._ptr.numpy(),
                                  np.asarray(jax.device_get(ref._ptr)))


def test_bucketed_sparse_scan_matches_reference_at_n64():
    """DSGD-AAU at N=64 through the explicit sparse mode: rungs 16/64 with
    merged rows on the narrow rung (``auto`` would pick the dense scan)."""
    ref, res_ref, port, res = _run_both("dsgd_aau", 64, "sparse_scan",
                                        eval_every=32)
    assert port.mode == "sparse_scan"
    assert port.scheduler.active_buckets() == (16, 64)
    assert choose_mode(64, (16, 64)) == "scan"
    _assert_same_run(res_ref, res)
    for k in port.W:
        np.testing.assert_allclose(port.W[k].numpy(),
                                   np.asarray(jax.device_get(ref.W[k])),
                                   atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(port.y.numpy(),
                               np.asarray(jax.device_get(ref.y)), atol=1e-5)


def test_bfloat16_policy_matches_reference_at_n64():
    """bf16 worker state (push-sum y stays float32).  The reference rounds
    W − η·G to bf16 before its mix where the port folds η into Q and sums in
    float32, so the losses agree to bf16 precision (1e-2), the stream-derived
    counters exactly."""
    ref, res_ref, port, res = _run_both("dsgd_aau", 64, "sparse_scan",
                                        eval_every=32, dtype="bfloat16")
    assert all(w.dtype == torch.bfloat16 for w in port.W.values())
    assert port.y.dtype == torch.float32
    assert res.bytes_per_scalar == res_ref.bytes_per_scalar == 2
    _assert_same_run(res_ref, res, loss_tol=1e-2)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    spec = ExperimentSpec(scales=(8,), max_events=8, max_time=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trainer(spec, "dsgd_aau", 8, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


@pytest.mark.parametrize("kw", [{"telemetry": True}, {"trace": True}])
def test_unported_options_raise(kw):
    sched = make_scheduler("dsgd_aau", build_graph("ring", 8),
                           get_scenario("paper_default", n=8, seed=0))
    with pytest.raises(NotImplementedError):
        DecentralizedTrainer(sched, mlp2nn_loss, mlp2nn_init(),
                             lambda w, s: None, {}, device="cpu", **kw)
