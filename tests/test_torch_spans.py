"""The port's host spans (``repro_torch.obs.spans``) on the CPU.

- Off (no profiler, no ``recording()``), a span records nothing, reads no
  clock and opens no profiler range.
- Under ``torch.profiler`` every recorded span has a host range of its
  name in the raw trace, starting within 1 ms of the record: spans share
  the trace's clock, and put nothing on the device timeline.
- Self time on hand-made nested records; parents, counts, the cap.
- A training step and a trainer run give bit-identical results with
  spans recording and without, and a sanitized run with spans recording
  raises no implicit transfer.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.obs import spans
from repro_torch.obs.spans import SpanRecord
from repro_torch.xp import build_trainer
from repro_torch.xp.presets import get_preset

SIM_SPANS = {"sim.run", "sim.events", "sim.pack", "sim.dispatch", "sim.eval",
             "sim.finish"}
TRAIN_SPANS = {"train.step", "train.worker", "train.forward",
               "train.backward", "train.sgd", "train.gossip"}
N_SIM, N_TRAIN = 8, 4


@pytest.fixture(autouse=True)
def fresh_table():
    """One intra-op thread (small runs; the runner's parallel workers
    would oversubscribe the cores) and an empty span table."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(threads)


def sim_trainer(mode="scan", sanitize=False):
    """Synchronous DSGD at N = 8 on the ``trace_tables`` cell's 2-NN."""
    spec = get_preset("trace_tables").replace(
        seeds=(0,), scenarios=("paper_default",), scales=(N_SIM,), mode=mode,
        max_events=6, ref_max_events=6, block_size=4, trace=False)
    tr = build_trainer(spec, "dsgd_sync", N_SIM, 0, device="cpu",
                       batch_pool=8)
    tr.sanitize = sanitize
    return tr


def sim_run(tr):
    res = tr.run(max_events=6, eval_every=3)
    return ({k: v.clone() for k, v in tr.W.items()},
            [(h.k, h.loss, h.n_active_mean) for h in res.history])


def train_cfg():
    """minicpm-2b at the widths of the benchmark's tiny training cell."""
    return dataclasses.replace(
        get_config("minicpm-2b").reduced(), d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=96, vocab_size=64,
        param_dtype="bfloat16", compute_dtype="bfloat16")


def train_step_run():
    cfg = train_cfg()
    W = ST.stacked_init(cfg, N_TRAIN, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (N_TRAIN, 1, 64)).astype(np.int64))
    step = ST.build_train_step(cfg, N_TRAIN, logit_chunk=16, device="cpu")
    W, loss = step(W, {"tokens": toks}, 0.05,
                   ST.default_gossip_weights(N_TRAIN, False))
    return W, loss


def names(recs):
    return {r.name for r in recs}


def test_off_records_nothing_reads_no_clock_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span that does not record called this")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans.time, "time_ns", refuse)
    sim_run(sim_trainer())
    train_step_run()
    assert spans.records() == [] and spans.dropped() == 0
    with spans.span("x", events=1) as counts:
        assert counts is None


@pytest.mark.parametrize("path", ["sim", "train"])
def test_spans_share_the_profilers_clock(path):
    tr = sim_trainer() if path == "sim" else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim_run(tr) if path == "sim" else train_step_run()
    recs = spans.records()
    assert names(recs) == (SIM_SPANS if path == "sim" else TRAIN_SPANS)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names(recs):
            assert e.device_type().name == "CPU"
            events.setdefault(e.name(), []).append(e.start_ns())
    for name in names(recs):
        mine = sorted(r.start_ns for r in recs if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000


def test_self_time_by_hand():
    recs = [SpanRecord("a", 0, 100, -1, {"n": 2}),
            SpanRecord("b", 10, 30, 0, {}),
            SpanRecord("c", 20, 25, 1, {}),
            SpanRecord("b", 40, 70, 0, {}),
            SpanRecord("b", 60, 120, 0, {}),     # past its parent's end
            SpanRecord("a", 200, 260, -1, {"n": 3}),
            None]                                # a span still open
    # a's children cover 10-30, 40-70 and (clipped) 70-100
    assert spans.self_ns(recs) == [20, 15, 5, 30, 60, 60, 0]
    rows = {r["name"]: r for r in spans.summary(recs, per=2)}
    assert rows["a"]["count"] == 1 and rows["a"]["counts"] == {"n": 2.5}
    assert rows["a"]["total_s"] == pytest.approx(80e-9)
    assert rows["a"]["self_s"] == pytest.approx((20 + 60) / 2 * 1e-9)
    assert rows["b"]["self_s"] == pytest.approx((15 + 30 + 60) / 2 * 1e-9)
    assert [r["name"] for r in spans.summary(recs)][0] == "a"


def test_recording_nests_parents_counts_and_cap(monkeypatch):
    with spans.recording():
        with spans.span("outer", n=1) as counts:
            counts["m"] = 2
            with spans.span("inner"):
                pass
            with spans.recording(), spans.span("inner"):
                pass
    with spans.span("after"):
        pass                                     # recording is off again
    recs = spans.records()
    assert [(r.name, r.parent, r.counts) for r in recs] == [
        ("outer", -1, {"n": 1, "m": 2}), ("inner", 0, {}), ("inner", 0, {})]
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[0].start_ns <= recs[1].start_ns <= recs[2].end_ns <= recs[0].end_ns
    monkeypatch.setattr(spans._TABLE, "cap", 4)
    with spans.recording():
        for _ in range(3):
            with spans.span("x"):
                pass
    assert len(spans.records()) == 4 and spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


def test_counts_of_the_work():
    """Sync DSGD: every worker takes a gradient each round; the step's
    tokens; the gossip reads and writes every stacked leaf once; each
    worker's forward counts its attention layers by route (T = 64: the
    materialised scores, ``_plain_attention``)."""
    with spans.recording():
        sim_run(sim_trainer())
        W, _ = train_step_run()
    recs = spans.records()
    total = {}
    for r in recs:
        for k, v in r.counts.items():
            total[(r.name, k)] = total.get((r.name, k), 0) + v
    assert total[("sim.events", "events")] == 6
    assert total[("sim.pack", "events")] == 6
    assert total[("sim.dispatch", "events")] == 6
    assert total[("sim.dispatch", "worker_steps")] == 6 * N_SIM
    assert total[("train.step", "tokens")] == N_TRAIN * 64
    assert total[("train.worker", "tokens")] == N_TRAIN * 64
    assert total[("train.gossip", "bytes")] == sum(
        2 * w.numel() * w.element_size() for w in W.values())
    workers = [r.counts["worker"] for r in recs if r.name == "train.worker"]
    assert workers == list(range(N_TRAIN))
    assert total[("train.forward", "attn_plain")] == (
        N_TRAIN * train_cfg().n_layers)
    assert total[("train.forward", "attn_fused")] == 0
    assert total[("train.forward", "attn_blockwise")] == 0


@pytest.mark.parametrize("how", ["recording", "profiler"])
@pytest.mark.parametrize("path", ["sim", "train"])
def test_spans_change_no_result(path, how):
    def once(on):
        if not on:
            return sim_run(sim_trainer()) if path == "sim" else train_step_run()
        ctx = (spans.recording() if how == "recording"
               else profile(activities=[ProfilerActivity.CPU]))
        with ctx:
            return sim_run(sim_trainer()) if path == "sim" else train_step_run()
    (W0, out0), (W1, out1) = once(False), once(True)
    assert spans.records()
    for k in W0:
        assert torch.equal(W0[k], W1[k]), k
    if path == "sim":
        assert out0 == out1
    else:
        assert torch.equal(out0, out1)


@pytest.mark.parametrize("mode", ["scan", "sparse_scan", "per_event"])
def test_sanitized_run_with_spans_recording(mode):
    tr = sim_trainer(mode, sanitize=True)
    with spans.recording():
        tr.run(max_events=6, eval_every=3)
    assert tr.sanitizer_stats.fetches == 1
    recorded = names(spans.records())
    assert {"sim.run", "sim.dispatch"} <= recorded
    if mode != "per_event":
        assert {"sim.events", "sim.eval", "sim.finish"} <= recorded


def test_off_is_one_shared_context():
    """Off, every span is the same no-op object: nothing is made for it."""
    assert spans.span("a") is spans.span("b", events=3)
    with spans.recording():
        assert spans.span("a") is not spans.span("a")
