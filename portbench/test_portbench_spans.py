"""The span metrics: each cell's traced run at a tiny size on the CPU reads
the span-table metrics (the CPU has no device trace, so
``sim_idle_outside_dispatch_pct`` finds nothing there), the idle reader
on a hand-built window, the table's window and self time by hand, and
every reader finds nothing where the program keeps no span table."""
import builtins
import json
import time
import types

import pytest

from portbench import harness, spantable, yardstick
from portbench.conftest import tiny_cell
from repro_torch.obs import spans
from repro_torch.obs.spans import SpanRecord

SPAN_METRICS = {
    "charlm_sync_n256": ["sim_event_gen_us_per_event"],
    "minicpm2b_train_w8": ["train_grad_issue_s_per_step",
                           "train_worker_self_s_per_step"]}
MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def fresh_table():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_tiny_cell_reads_the_span_metrics(workload):
    result = harness.execute(tiny_cell(workload), 2**31 + 19, 0.05, True,
                             "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    for name in SPAN_METRICS[workload]:
        assert result["metrics"][name]["value"] >= 0.0, name
    assert "sim_idle_outside_dispatch_pct" not in result["metrics"]


def window(device, host, window_s):
    """A ``yardstick.Window`` of hand-made device and host events (µs)."""
    def ev(name, s, e, dev):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=s, end=e),
            device_type=types.SimpleNamespace(name=dev))
    prof = types.SimpleNamespace(events=lambda: (
        [ev(*d, "CUDA") for d in device] + [ev(*h, "CPU") for h in host]))
    return yardstick.Window(prof, window_s)


def test_idle_outside_dispatch_by_hand():
    # device busy 0-10, 20-30, 50-60 µs: gaps 10-20 and 30-50 (30 µs idle);
    # dispatch covers 15-35, so 10-15 and 35-50 are left (20 µs)
    win = window([("k", 0, 10), ("k", 5, 10), ("k", 20, 30), ("k", 50, 60)],
                 [("sim.run", 0, 60), ("sim.dispatch", 15, 25),
                  ("sim.dispatch", 22, 35), ("aten::mm", 36, 40)], 1e-4)
    v = harness.read_metric("sim_idle_outside_dispatch_pct",
                            {"window": win})
    assert v == pytest.approx(100 * 20e-6 / 1e-4)
    idle = harness.read_metric("sim_device_idle_pct", {"window": win})
    assert idle == pytest.approx(70.0) and 0 <= v <= idle
    # no dispatch range (a program without spans), no device: nothing
    for w in (window(win.device, [("sim.run", 0, 60)], 1e-4),
              window([], win.host, 1e-4)):
        assert harness.read_metric("sim_idle_outside_dispatch_pct",
                                   {"window": w}) is None


def test_window_and_self_time_by_hand():
    spans._TABLE._records[:] = [
        SpanRecord("train.step", 0, 100, -1, {}),       # before the window
        SpanRecord("train.step", 200, 400, -1, {}),
        SpanRecord("train.worker", 200, 300, 1, {}),
        SpanRecord("train.forward", 210, 240, 2, {}),
        SpanRecord("train.backward", 240, 290, 2, {}),
        SpanRecord("train.step", 500, 700, -1, {}),
        SpanRecord("train.worker", 500, 600, 5, {}),
        SpanRecord("train.forward", 500, 550, 6, {}),
        SpanRecord("train.sgd", 590, 600, 6, {})]
    win = spantable.window("train.step", 2)
    assert [i for i, _ in win] == list(range(1, 9))
    assert spantable.seconds(win, ("train.forward", "train.backward"),
                             own=False) == pytest.approx(130e-9)
    assert spantable.seconds(win, ("train.worker",),
                             own=True) == pytest.approx((20 + 40) * 1e-9)
    ctx = {"steps": 2}
    assert harness.read_metric("train_grad_issue_s_per_step",
                               ctx) == pytest.approx(65e-9)
    assert harness.read_metric("train_worker_self_s_per_step",
                               ctx) == pytest.approx(30e-9)
    assert spantable.window("train.step", 4) is None
    assert harness.read_metric("train_grad_issue_s_per_step",
                               {"steps": 0}) is None
    spans._TABLE.dropped = 1
    assert spantable.window("train.step", 2) is None


def test_readers_find_nothing_without_a_span_table(monkeypatch):
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name.startswith("repro_torch.obs"):
            raise ImportError(name)
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_spans)
    win = window([("k", 0, 10)], [("sim.run", 0, 60)], 1e-4)
    ctx = {"window": win, "events": 4, "steps": 1}
    for names in SPAN_METRICS.values():
        for name in names:
            assert harness.read_metric(name, ctx) is None, name


@pytest.mark.parametrize("name", [n for ns in SPAN_METRICS.values()
                                  for n in ns]
                         + ["sim_idle_outside_dispatch_pct"])
def test_span_metrics_in_the_manifest(name):
    m = {e["name"]: e for e in MANIFEST["per_layer"]}[name]
    assert m["source"] == "program_span" and len(m["workloads"]) == 1
    assert MANIFEST["per_layer"].index(m) >= len(MANIFEST["per_layer"]) - 4
