"""The port's experiment CLI and trainer surface against the reference's.

``python -m repro_torch.xp --device cpu`` against ``python -m repro.xp`` on
the ``smoke`` and ``fused_smoke`` presets, both called in-process.  The
port's cells start from the reference's W0 (``mlp2nn_init()(PRNGKey(seed))``
carried across with ``params_from_numpy``, injected into
``repro_torch.xp.sweep.build_trainer`` by a test-only monkeypatch), so:
event counts, virtual times and copies match exactly; losses and the
aggregates built from them within 1e-4 (the bf16 probe row 2e-2); the
telemetry and trace sections as in ``tests/test_torch_obs.py``.

Then ``RunResult``'s members, the constructor's ``same_init``,
``events_per_step``, ``native_generation`` and ``eta_decay_every`` against
the reference, ``run_algorithms``, and the CLI's refusal to fall back to
the CPU.
"""
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.xp.builders as ref_builders
from repro.core.runner import DecentralizedTrainer as RefTrainer
from repro.core.runner import HistoryPoint as RefPoint
from repro.core.runner import RunResult as RefResult
from repro.xp.__main__ import main as ref_main
from repro.xp.builders import build_trainer as ref_build_trainer
from repro.xp.builders import mlp2nn_init as ref_init
from repro.xp.spec import ExperimentSpec as RefSpec
import repro_torch.xp.builders as port_builders
from repro_torch.core.runner import DecentralizedTrainer, HistoryPoint
from repro_torch.core.runner import RunResult, run_algorithms
from repro_torch.xp import ExperimentSpec, build_trainer, params_from_numpy
from repro_torch.xp import sweep as port_sweep
from repro_torch.xp.__main__ import main as port_main
from test_torch_obs import assert_same_tax, assert_same_telemetry

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small runs gain nothing from more, and
    the test runner's parallel workers would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_w0(seed):
    return jax.device_get(ref_init()(jax.random.PRNGKey(seed)))


def _run_clis(monkeypatch, tmp_path, args):
    """Both CLIs on ``args``; returns (reference, port) artifacts and run
    logs."""
    real = port_sweep.build_trainer

    def with_ref_w0(spec, alg, n, seed, **kw):
        w0 = params_from_numpy(_ref_w0(seed), device=kw["device"])
        return real(spec, alg, n, seed, init_params=w0, **kw)

    monkeypatch.setattr(port_sweep, "build_trainer", with_ref_w0)
    out = {}
    for side, main, extra in (("ref", ref_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        art, log = tmp_path / f"{side}.json", tmp_path / f"{side}.jsonl"
        assert main(args + extra + ["--out", str(art),
                                    "--run-log", str(log)]) == 0
        out[side] = (json.loads(art.read_text()),
                     [json.loads(line) for line in log.read_text().split("\n")
                      if line])
    return out["ref"], out["port"]


def _close(a, b, tol):
    if isinstance(a, str) or isinstance(b, str):     # "nan" / "inf"
        assert str(a) == str(b)
    else:
        assert b == pytest.approx(a, abs=tol)


@pytest.mark.parametrize("preset,flags", [
    ("smoke", ["--smoke", "--telemetry", "--trace"]),
    ("fused_smoke", ["--preset", "fused_smoke", "--telemetry"])])
def test_cli_matches_reference(preset, flags, monkeypatch, tmp_path):
    (ref, ref_log), (port, port_log) = _run_clis(monkeypatch, tmp_path,
                                                 flags)
    assert port.keys() == ref.keys()
    # the specs differ only in where each run log went
    assert dict(port["meta"]["spec"], run_log=None) == \
        dict(ref["meta"]["spec"], run_log=None)
    assert port["meta"]["torch"] == torch.__version__
    assert (port["meta"]["device"], port["meta"]["power_limit"]) == \
        ("cpu", "cpu")
    assert port["scenarios"] == ref["scenarios"]
    for a, b in zip(ref["speedup_vs_n"], port["speedup_vs_n"]):
        assert a.keys() == b.keys()
        for key in a:
            if key.endswith("_mean") or key.endswith("_std"):
                _close(a[key], b[key], 1e-4)
            else:
                assert b[key] == a[key], key
    assert len(port["convergence"]) == len(ref["convergence"])
    for a, b in zip(ref["convergence"], port["convergence"]):
        assert [(p["k"], p["time_mean"]) for p in b["points"]] == \
            [(p["k"], p["time_mean"]) for p in a["points"]]
        for p, q in zip(a["points"], b["points"]):
            for key in ("loss_mean", "loss_std", "metric_mean"):
                _close(p[key], q[key], 1e-4)
    for a, b in zip(ref["dtype_policy"], port["dtype_policy"]):
        assert (b["dtype"], b["algorithm"], b["n"], b["events"]) == \
            (a["dtype"], a["algorithm"], a["n"], a["events"])
        tol = 2e-2 if a["dtype"] == "bfloat16" else 1e-4
        _close(a["final_loss"], b["final_loss"], tol)
    assert len(port.get("telemetry", [])) == len(ref.get("telemetry", []))
    for a, b in zip(ref.get("telemetry", []), port.get("telemetry", [])):
        assert_same_telemetry(a, b)
    for a, b in zip(ref.get("trace", []), port.get("trace", [])):
        assert_same_tax(a, b)
    # every run's start and end, in order, with the same totals
    ends = [[(r["event"], r.get("algorithm"), r.get("rounds"), r.get("t"),
              r.get("comm")) for r in log
             if r["event"] in ("run_start", "run_end", "staleness_bound")]
            for log in (ref_log, port_log)]
    assert ends[1] == ends[0]


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(["--smoke"])


def test_trace_tables_preset_runs_on_the_cpu(tmp_path):
    """``--preset trace_tables`` cut to one seed writes the schema of the
    reference's recorded ``BENCH_trace.json``."""
    out = tmp_path / "trace.json"
    assert port_main(["--preset", "trace_tables", "--seeds", "0",
                      "--scenarios", "paper_default", "--device", "cpu",
                      "--out", str(out)]) == 0
    port = json.loads(out.read_text())
    ref = json.loads((ROOT / "BENCH_trace.json").read_text())
    assert port.keys() == ref.keys()
    assert set(port["meta"]) == set(ref["meta"]) - {"jax"} | {
        "torch", "device", "power_limit"}
    for section in ("speedup_vs_n", "convergence", "trace"):
        assert port[section] and port[section][0].keys() == \
            ref[section][0].keys()
    assert {r["algorithm"] for r in port["trace"]} == {
        "dsgd_sync", "dsgd_aau", "ad_psgd"}
    assert all(r["events"] == 200 for r in port["trace"])


def test_run_result_members_match_reference():
    pts = [(9, 1.5, 2.1), (19, 3.0, 1.2), (29, 4.5, 0.85), (39, 6.0, 0.8)]
    kw = dict(algorithm="x", final_loss=0.8, final_metric=0.5,
              total_events=40, total_time=6.0, total_comm_copies=123,
              param_count=85002, bytes_per_scalar=2)
    ref = RefResult(history=[RefPoint(k, t, loss, 0.0, 0, 1.0)
                             for k, t, loss in pts], **kw)
    port = RunResult(history=[HistoryPoint(k, t, loss, 0.0, 0, 1.0)
                              for k, t, loss in pts], **kw)
    for target in (3.0, 1.2, 0.9, 0.8, 0.1):
        assert port.time_to_loss(target) == ref.time_to_loss(target)
        assert port.iters_to_loss(target) == ref.iters_to_loss(target)
    assert port.comm_bytes() == ref.comm_bytes() == 123 * 85002 * 2
    assert port.comm_bytes(4) == ref.comm_bytes(4)
    assert port.telemetry is None and port.trace is None


EVENTS = 64


def _with_option(monkeypatch, **opt):
    """Both packages' builders construct their trainers with ``opt``."""
    monkeypatch.setattr(ref_builders, "DecentralizedTrainer",
                        functools.partial(RefTrainer, **opt))
    monkeypatch.setattr(port_builders, "DecentralizedTrainer",
                        functools.partial(DecentralizedTrainer, **opt))


def _run_pair(alg, n, mode, init_params, **kw):
    spec_kw = dict(scales=(n,), seeds=(0,), mode=mode, max_time=None,
                   max_events=EVENTS, eta0=0.2, eta_decay=0.99)
    ref = ref_build_trainer(RefSpec(**spec_kw), alg, n, 0, **kw)
    port = build_trainer(ExperimentSpec(**spec_kw), alg, n, 0, device="cpu",
                         init_params=init_params, **kw)
    assert port.mode == ref.mode == mode
    return (ref, ref.run(max_events=EVENTS, eval_every=16),
            port, port.run(max_events=EVENTS, eval_every=16))


def _assert_same(ref, res_ref, port, res, tol=1e-4):
    assert (res.total_events, res.total_time, res.total_comm_copies) == \
        (res_ref.total_events, res_ref.total_time, res_ref.total_comm_copies)
    for a, b in zip(res_ref.history, res.history):
        assert (b.k, b.time, b.comm_param_copies) == \
            (a.k, a.time, a.comm_param_copies)
        assert b.loss == pytest.approx(a.loss, abs=tol)
    for k in port.W:
        np.testing.assert_allclose(port.W[k].numpy(),
                                   np.asarray(jax.device_get(ref.W[k])),
                                   atol=tol)


def test_same_init_false_matches_reference_with_per_worker_w0(monkeypatch):
    """The reference draws one W0 per worker from ``jax.random.split``; the
    port takes those n parameter sets as a per-worker ``init_params``."""
    n = 16
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    per_worker = [params_from_numpy(jax.device_get(ref_init()(k)),
                                    device="cpu") for k in keys]
    monkeypatch.setattr(ref_builders, "DecentralizedTrainer",
                        functools.partial(RefTrainer, same_init=False))
    ref, res_ref, port, res = _run_pair("dsgd_aau", n, "scan", per_worker)
    w1 = port.W["w1"]
    assert not torch.equal(w1[0], w1[1])
    _assert_same(ref, res_ref, port, res)
    with pytest.raises(ValueError, match="workers' parameters"):
        build_trainer(ExperimentSpec(scales=(n,), max_events=8,
                                     max_time=None), "dsgd_aau", n, 0,
                      device="cpu", init_params=per_worker[:3])


@pytest.mark.parametrize("opt", [{"events_per_step": 1},
                                 {"native_generation": False},
                                 {"eta_decay_every": 4}])
def test_trainer_options_match_reference(opt, monkeypatch):
    _with_option(monkeypatch, **opt)
    w0 = params_from_numpy(_ref_w0(0), device="cpu")
    ref, res_ref, port, res = _run_pair("dsgd_aau", 16, "sparse_scan", w0)
    for name, value in opt.items():
        assert getattr(port, name) == value
    _assert_same(ref, res_ref, port, res)
    if "events_per_step" in opt:
        assert port._events_per_step(16) == 1


def test_run_algorithms_runs_each_scheduler():
    spec = ExperimentSpec(scales=(8,), max_events=16, max_time=None,
                          mode="scan")
    trainers = {alg: build_trainer(spec, alg, 8, 0, device="cpu")
                for alg in ("dsgd_aau", "ad_psgd")}
    out = run_algorithms({alg: t.scheduler for alg, t in trainers.items()},
                         lambda sched: trainers[sched.name],
                         max_events=16, eval_every=8)
    assert {alg: r.total_events for alg, r in out.items()} == \
        {"dsgd_aau": 16, "ad_psgd": 16}
