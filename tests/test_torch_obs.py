"""The port's observability layer against the reference's, on the CPU.

Telemetry, trace, run log and sanitizer of ``repro_torch`` held against
``repro`` on the same experiment cells: both packages build the cell from
one ``ExperimentSpec`` (the same NumPy event stream, data and pools) and
start from the reference's W0 carried across with ``params_from_numpy``.

- Telemetry (``metrics_summary``): integer counters exactly, float fields
  within 1e-4, in every trainer mode -- ``scan``, ``sparse_scan`` with
  merged rows (N=16) and bucketed rungs (N=24, the smallest N whose
  DSGD-AAU ladder has two rungs), ``per_event`` and ``fused``.
- Trace: the ``Trace`` arrays equal and ``straggler_tax`` within 1e-6.
- Run log: the same sequence of event names.
- Sanitizer: raises on an implicit conversion, passes a clean run.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.check import runtime as ref_runtime
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro.xp.builders import build_trainer as ref_build_trainer
from repro.xp.builders import mlp2nn_init as ref_init
from repro.xp.presets import get_preset as ref_get_preset
from repro_torch.check import runtime
from repro_torch.obs import load_run_log
from repro_torch.obs import metrics
from repro_torch.obs import trace as port_trace
from repro_torch.xp import build_trainer, params_from_numpy
from repro_torch.xp.presets import get_preset

EVENTS = 48
FLOAT_FIELDS = ("busy_t", "idle_t", "utilization", "utilization_mean",
                "mix_age", "stale_mean")
TRACE_ARRAYS = ("times", "copies", "lane_ev", "lane_worker", "lane_fin",
                "lane_grad", "lane_restart", "edge_ev", "edge_src",
                "edge_dst")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small runs gain nothing from more, and
    the test runner's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec_kw(n, mode, **kw):
    """``trace_tables`` cut to one seed, one scenario, 48 events and the
    cell's N and mode (the dense scan's ``auto`` choice at N=16)."""
    return dict(seeds=(0,), scenarios=("paper_default",), scales=(n,),
                mode=mode, max_events=EVENTS, ref_max_events=EVENTS,
                block_size=16, **kw)


def _port(alg, n, mode, spec_kw=None, log=None):
    """The port's trainer of one cell, from the reference's W0."""
    spec = get_preset("trace_tables").replace(
        run_log=log, **_spec_kw(n, mode, **(spec_kw or {})))
    w0 = jax.device_get(ref_init()(jax.random.PRNGKey(0)))
    port = build_trainer(spec, alg, n, 0, device="cpu", batch_pool=EVENTS,
                         init_params=params_from_numpy(w0, device="cpu"))
    assert port.mode == mode
    return port


def _pair(alg, n, mode, spec_kw=None, logs=(None, None)):
    """(reference, port) trainers of one cell from one W0; ``logs`` are
    the two sides' run-log paths."""
    ref_spec = ref_get_preset("trace_tables").replace(
        run_log=logs[0], **_spec_kw(n, mode, **(spec_kw or {})))
    ref = ref_build_trainer(ref_spec, alg, n, 0, batch_pool=EVENTS)
    port = _port(alg, n, mode, spec_kw, logs[1])
    assert dict(ref_spec.to_dict(), run_log=None) == dict(
        get_preset("trace_tables").replace(
            **_spec_kw(n, mode, **(spec_kw or {}))).to_dict())
    assert ref.mode == mode
    return ref, port


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell run once on both sides with telemetry, trace and a run
    log, shared by the telemetry, trace and run-log tests."""
    done = {}

    def run(alg, n, mode):
        if (alg, n, mode) not in done:
            d = tmp_path_factory.mktemp(f"{alg}-{n}-{mode}")
            logs = (str(d / "ref.jsonl"), str(d / "port.jsonl"))
            ref, port = _pair(alg, n, mode, {"telemetry": True},
                              logs=logs)
            res_ref = ref.run(max_events=EVENTS, eval_every=24)
            res = port.run(max_events=EVENTS, eval_every=24)
            done[(alg, n, mode)] = (ref, res_ref, port, res, logs)
        return done[(alg, n, mode)]

    return run


def assert_same_telemetry(a, b):
    """``b`` (port) against ``a`` (reference): integers exactly, floats
    within 1e-4."""
    assert a.keys() == b.keys()
    for key in a:
        if key in FLOAT_FIELDS:
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-4,
                                       err_msg=key)
        elif key == "bucket_occupancy":
            assert [(r["A"], r["events"]) for r in b[key]] == \
                [(r["A"], r["events"]) for r in a[key]]
            np.testing.assert_allclose([r["lane_fill"] for r in b[key]],
                                       [r["lane_fill"] for r in a[key]])
        else:
            assert b[key] == a[key], key


def assert_same_trace(a, b):
    for key in TRACE_ARRAYS:
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                      err_msg=key)
    assert (b.n, b.algorithm, b.mode) == (a.n, a.algorithm, a.mode)


def assert_same_tax(a, b):
    assert a.keys() == b.keys()
    for key, va in a.items():
        if isinstance(va, dict):
            assert_same_tax(va, b[key])
        elif key == "blame_top":
            assert [r["worker"] for r in b[key]] == [r["worker"] for r in va]
        elif isinstance(va, (list, float)):
            np.testing.assert_allclose(b[key], va, rtol=0, atol=1e-6)
        else:
            assert b[key] == va, key


CELLS = [("dsgd_aau", 16, "scan"), ("dsgd_sync", 16, "scan"),
         ("dsgd_aau", 16, "sparse_scan"), ("dsgd_aau", 24, "sparse_scan"),
         ("ad_psgd", 16, "sparse_scan"), ("dsgd_aau", 16, "per_event"),
         ("ad_psgd", 16, "fused")]


@pytest.mark.parametrize("alg,n,mode", CELLS)
def test_telemetry_matches_reference(alg, n, mode, cells):
    ref, res_ref, port, res, _ = cells(alg, n, mode)
    if (alg, n, mode) == ("dsgd_aau", 24, "sparse_scan"):
        assert port.scheduler.active_buckets() == (16, 24)
    assert_same_telemetry(res_ref.telemetry, res.telemetry)
    assert res.telemetry["comm_copies"] == res.total_comm_copies
    assert sum(res.telemetry["grad_steps"]) > 0
    if alg == "dsgd_aau":
        assert res.telemetry["staleness_bound"]["ok"]
    if mode == "sparse_scan":
        assert res.telemetry["bucket_occupancy"]


@pytest.mark.parametrize("mode", ["sparse_scan", "fused"])
def test_telemetry_leaves_the_state_alone(mode, cells):
    """The metrics read the event arrays, never the worker state: the
    trajectory with telemetry is the trajectory without it, bit for bit."""
    alg = "dsgd_aau" if mode == "sparse_scan" else "ad_psgd"
    _, _, watched, _, _ = cells(alg, 16, mode)
    plain = _port(alg, 16, mode, {"trace": False})
    plain.run(max_events=EVENTS, eval_every=24)
    for k in plain.W:
        assert torch.equal(plain.W[k], watched.W[k])
        assert torch.equal(plain.S[k], watched.S[k])
    assert torch.equal(plain.y, watched.y)
    assert torch.equal(plain._ptr, watched._ptr)


@pytest.mark.parametrize("alg,mode", [("dsgd_sync", "scan"),
                                      ("dsgd_aau", "scan"),
                                      ("ad_psgd", "scan"),
                                      ("dsgd_aau", "sparse_scan"),
                                      ("ad_psgd", "fused")])
def test_trace_matches_reference(alg, mode, cells):
    """``trace_tables`` cut to one seed, one scenario and 48 events: the
    dense scan its ``auto`` takes at N=16, plus the sparse and fused
    recorders."""
    ref, res_ref, port, res, _ = cells(alg, 16, mode)
    assert res.trace["events"] == EVENTS
    assert_same_trace(ref.last_trace, port.last_trace)
    assert_same_tax(res_ref.trace, res.trace)


@pytest.mark.parametrize("alg,n,mode", [("dsgd_aau", 16, "scan"),
                                        ("dsgd_aau", 24, "sparse_scan"),
                                        ("ad_psgd", 16, "sparse_scan"),
                                        ("dsgd_aau", 16, "per_event"),
                                        ("ad_psgd", 16, "fused")])
def test_run_log_matches_reference(alg, n, mode, cells, tmp_path,
                                   monkeypatch):
    """The same sequence of run-log events with telemetry on: run_start,
    rng_order, compile, block_dispatch / bucket_segment, staleness_bound,
    run_end.  A sanitized port run adds one ``sanitize`` record where the
    reference puts it, after run_start and rng_order (the reference's
    sanitized runs are not repeated here: under ``jax.checking_leaks``
    they take tens of seconds)."""
    *_, logs = cells(alg, n, mode)
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    log = str(tmp_path / "sanitized.jsonl")
    sanitized = _port(alg, n, mode, {"telemetry": True}, log)
    assert sanitized.sanitize
    sanitized.run(max_events=EVENTS, eval_every=24)
    names = [[r["event"] for r in load_run_log(path)]
             for path in logs + (log,)]
    assert names[1] == names[0]
    assert names[1][-1] == "run_end"
    at = 2 if names[1][1] == "rng_order" else 1
    assert names[2] == names[1][:at] + ["sanitize"] + names[1][at:]


def test_sanitizer_refuses_implicit_conversions():
    x = torch.arange(4.0)
    with runtime.sanitized() as stats:
        for convert in (lambda: x.sum().item(), lambda: float(x[0]),
                        lambda: x.tolist(), lambda: np.asarray(x),
                        lambda: bool(x[1] > 0), lambda: x.numpy(),
                        lambda: [0, 1][x[1].long()]):
            with pytest.raises(RuntimeError, match="implicit"):
                convert()
        vals, total = runtime.fetch(x, x.sum().to(torch.int32))
        assert vals.tolist() == [0.0, 1.0, 2.0, 3.0]
        assert total.dtype == np.int32 and int(total) == 6
        assert stats.fetches == 1
    assert x.sum().item() == 6.0          # the guard is gone again
    assert "item" not in torch.Tensor.__dict__


def test_sanitizer_raises_inside_the_loop_and_passes_a_clean_run(monkeypatch):
    port = _port("dsgd_aau", 16, "sparse_scan", {"telemetry": True})
    port.sanitize = True
    res = port.run(max_events=EVENTS, eval_every=24)
    # the eval history (with the pool check), the telemetry drain
    assert port.sanitizer_stats.fetches == 2
    assert res.telemetry is not None and res.trace is not None

    orig = type(port)._dispatch_sparse_block

    def leaky(self, *args, **kw):
        self.y.sum().item()                # an implicit sync in the loop
        return orig(self, *args, **kw)

    monkeypatch.setattr(type(port), "_dispatch_sparse_block", leaky)
    with pytest.raises(RuntimeError, match="implicit device→host"):
        port.run(max_events=EVENTS, eval_every=24)


@pytest.mark.parametrize("value", ["", "0", "1", "true", "off", " Yes "])
def test_sanitize_flag_matches_reference(value):
    assert runtime.sanitize_enabled(value) == \
        ref_runtime.sanitize_enabled(value)


def _random_payload(rng, n, E, A):
    workers = np.full((E, A), -1, dtype=np.int32)
    for e in range(E):
        m = rng.integers(1, A + 1)
        workers[e, :m] = np.sort(rng.choice(n, size=m, replace=False))
    valid = workers >= 0
    gm = valid & (rng.random((E, A)) < 0.7)
    rm = gm | (valid & (rng.random((E, A)) < 0.2))
    P = rng.random((E, A, A)).astype(np.float32) * (rng.random((E, A, A))
                                                     < 0.5)
    ts = np.cumsum(rng.random(E)).astype(np.float32)
    fin = (ts[:, None] - rng.random((E, A))).astype(np.float32)
    copies = rng.integers(0, 5, size=E).astype(np.int32)
    return workers, valid, gm, rm, P, ts, fin, copies


def _same_carry(ref_M, M, atol=0.0):
    host = jax.device_get(ref_M)
    for name, a, b in zip(metrics.MetricsCarry._fields, host, M):
        assert b.dtype == torch.int32 if np.asarray(a).dtype == np.int32 \
            else b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol, err_msg=name)


def test_metric_updates_match_reference():
    """dense, sparse (step by step), block and fused folds on random
    payloads: integer accumulators exactly, float32 ones to 1e-5."""
    rng = np.random.default_rng(0)
    n, E, A = 12, 10, 5
    workers, valid, gm, rm, P, ts, fin, copies = _random_payload(
        rng, n, E, A)
    ks = np.arange(3, 3 + E, dtype=np.int32)
    # sparse rows, one at a time
    M_ref, M = ref_metrics.init_metrics(n), metrics.init_metrics(n, "cpu")
    for e in range(E):
        ts_l = np.full(A, ts[e], np.float32)
        ks_l = np.full(A, ks[e], np.int32)
        M_ref = ref_metrics.sparse_metrics_update(
            M_ref, jnp.asarray(workers[e]), jnp.asarray(P[e]),
            jnp.asarray(gm[e]), jnp.asarray(rm[e]), jnp.asarray(ts_l),
            jnp.asarray(fin[e]), jnp.asarray(ks_l), jnp.int32(copies[e]))
        M = metrics.sparse_metrics_update(
            M, torch.as_tensor(workers[e]), torch.as_tensor(P[e]),
            torch.as_tensor(gm[e]), torch.as_tensor(rm[e]),
            torch.as_tensor(ts_l), torch.as_tensor(fin[e]),
            torch.as_tensor(ks_l), int(copies[e]))
    _same_carry(M_ref, M)
    # the same events densely
    Pd = np.zeros((E, n, n), np.float32)
    gmd, rmd = np.zeros((E, n), bool), np.zeros((E, n), bool)
    find = np.repeat(ts[:, None], n, axis=1)
    for e in range(E):
        w = workers[e][valid[e]]
        m = len(w)
        Pd[e][np.ix_(w, w)] = P[e][:m, :m]
        gmd[e, w], rmd[e, w], find[e, w] = gm[e, :m], rm[e, :m], fin[e, :m]
    D_ref, D = ref_metrics.init_metrics(n), metrics.init_metrics(n, "cpu")
    for e in range(E):
        D_ref = ref_metrics.dense_metrics_update(
            D_ref, jnp.asarray(Pd[e]), jnp.asarray(gmd[e]),
            jnp.asarray(rmd[e]), jnp.float32(ts[e]), jnp.asarray(find[e]),
            jnp.int32(ks[e]), jnp.int32(copies[e]))
        D = metrics.dense_metrics_update(
            D, torch.as_tensor(Pd[e]), torch.as_tensor(gmd[e]),
            torch.as_tensor(rmd[e]), torch.tensor(ts[e]),
            torch.as_tensor(find[e]), int(ks[e]), int(copies[e]))
    _same_carry(D_ref, D)
    # the whole block at once
    coupled = np.zeros((E, A), bool)
    for e in range(E):
        off = P[e] * (1 - np.eye(A, dtype=np.float32))
        coupled[e] = (off != 0).any(0) | (off != 0).any(1)
    B_ref = ref_metrics.block_metrics_update(
        ref_metrics.init_metrics(n), *map(jnp.asarray, (
            workers, gm, rm, coupled, ts, fin, ks, copies)))
    B = metrics.block_metrics_update(
        metrics.init_metrics(n, "cpu"), *map(torch.as_tensor, (
            workers, gm, rm, coupled, ts, fin, ks, copies)))
    _same_carry(B_ref, B, atol=1e-5)
    # a fused stream folded at drain
    i_seq = rng.integers(0, n, size=40)
    p_seq = np.where(rng.random(40) < 0.8, (i_seq + 1) % n, -1)
    t_ev = np.cumsum(rng.random(40)).astype(np.float32)
    t_raw = (t_ev - 0.1 * rng.random(40)).astype(np.float32)
    F_ref = ref_metrics.fused_metrics_fold(
        ref_metrics.init_metrics(n), jnp.asarray(i_seq, jnp.int32),
        jnp.asarray(p_seq, jnp.int32), jnp.asarray(t_raw),
        jnp.asarray(t_ev), 2, jnp.int32(0))
    F = metrics.fused_metrics_fold(
        metrics.init_metrics(n, "cpu"), torch.as_tensor(i_seq),
        torch.as_tensor(p_seq), torch.as_tensor(t_raw),
        torch.as_tensor(t_ev), 2, 0)
    _same_carry(F_ref, F, atol=1e-5)
    s = np.array([-3, -1, 0, 1, 2, 3, 6, 7, 1000, 2 ** 15 - 2, 2 ** 15,
                  2 ** 20], np.int32)
    np.testing.assert_array_equal(
        metrics._stale_bins(torch.as_tensor(s)).numpy(),
        np.asarray(ref_metrics._stale_bins(jnp.asarray(s))))
    for bound in (False, True):
        assert metrics.metrics_summary(D, 20.0, bound) == \
            ref_metrics.metrics_summary(D_ref, 20.0, bound)


def test_trace_cli_and_chrome_export_match_reference(cells, tmp_path):
    """A port run's log and trace through both packages' exporters."""
    _, _, port, _, (_, log) = cells("dsgd_aau", 24, "sparse_scan")
    records = load_run_log(log)
    assert records == ref_trace.load_run_log(log)
    assert port_trace.chrome_trace(port.last_trace, records) == \
        ref_trace.chrome_trace(port.last_trace, records)
    outs = [str(tmp_path / f"{side}.json") for side in ("port", "ref")]
    assert port_trace.main([log, "-o", outs[0]]) == 0
    assert ref_trace.main([log, "-o", outs[1]]) == 0
    with open(outs[0]) as a, open(outs[1]) as b:
        assert json.load(a) == json.load(b)
