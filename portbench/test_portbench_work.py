"""The yardstick's counts against hand counts at tiny shapes: the model's
FLOPs, each roofline metric's work, the trace's busy time and gaps, and the
comparison's numbers."""
import math
import types

import pytest
import torch

from portbench import check, inputs, yardstick
from portbench.harness import read_metric

TINY = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "intermediate_size": 12, "vocab_size": 10,
        "tie_word_embeddings": True, "torch_dtype": "float32"}


def test_matmul_params_and_flops_by_hand():
    # a layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, three 8x12 MLP matrices
    per_layer = 64 + 32 + 32 + 64 + 3 * 96
    assert yardstick.matmul_params(TINY) == 2 * per_layer + 8 * 10
    # 6 a product parameter a token, and 6·L·d·T of causal attention
    flops = yardstick.train_flops(TINY, seq_len=5, tokens=20)
    assert flops == 20 * (6 * (2 * per_layer + 80) + 6 * 2 * 8 * 5)


def test_param_shapes_count_the_leaves():
    shapes = inputs.param_shapes(dict(TINY, tie_word_embeddings=False))
    total = sum(math.prod(s) for s in shapes.values())
    assert total == 10 * 8 + 2 * (8 + 64 + 32 + 32 + 64 + 8 + 3 * 96) + 8 + 80


class FakeWindow:
    def __init__(self, seconds):
        self.seconds = seconds
        self.window_s = 2.0
        self.device = [("k", 0.0, 1.0)]

    def device_s(self, patterns):
        return self.seconds


def ctx(**kw):
    base = dict(config=dict(TINY), param_shapes={"a": (3, 4), "b": (5,)},
                window=FakeWindow(1e-6))
    base.update(kw)
    return base


def test_gossip_mix_roofline_by_hand():
    # N = 4 bf16: a leaf of D reads 4·D and writes 4·D elements of 2 bytes
    c = ctx(config=dict(TINY, torch_dtype="bfloat16"),
            traffic={"workers": 4}, steps=3)
    D = 12 + 5
    bytes_ = 3 * 2 * 4 * D * 2
    assert read_metric("gossip_mix_roofline_pct", c) == pytest.approx(
        100 * bytes_ / 3.35e12 / 1e-6)


def test_masked_gossip_roofline_by_hand():
    c = ctx(traffic={"workers": 4}, events=2)
    bound = sum(max(12 * 4 * D / 3.35e12, 4 * 16 * D / 495e12) for D in (12, 5))
    assert read_metric("masked_gossip_roofline_pct", c) == pytest.approx(
        100 * 2 * bound / 1e-6)


def test_sparse_gossip_roofline_by_hand():
    # 7 active rows in all: W and G rows read, W and S rows written
    c = ctx(traffic={"workers": 256}, active_sum=7.0)
    assert read_metric("sparse_gossip_roofline_pct", c) == pytest.approx(
        100 * 16 * 7 * 17 / 3.35e12 / 1e-6)


def test_mfu_and_idle_and_launches():
    c = ctx(traffic={"seq_len": 5, "data": {"batch": 2, "seq_len": 5}},
            tokens=20, active_sum=2.0, steps=4, worker_steps=4)
    c["window"].busy_s = 0.5
    flops = yardstick.train_flops(TINY, 5, 20)
    # over the device's busy time, not the window's
    assert read_metric("train_mfu_pct", c) == pytest.approx(
        100 * flops / (0.5 * 495e12))
    assert read_metric("sim_mfu_pct", c) == pytest.approx(
        100 * flops / (0.5 * 495e12))
    assert read_metric("sim_device_idle_pct", c) == pytest.approx(75.0)
    assert read_metric("train_launches_per_step", c) == 0.25


def test_readers_find_nothing_without_their_kernels():
    c = ctx(traffic={"workers": 4}, steps=1, events=1, active_sum=1.0,
            window=FakeWindow(None))
    for name in ("gossip_mix_roofline_pct", "masked_gossip_roofline_pct",
                 "sparse_gossip_roofline_pct"):
        assert read_metric(name, c) is None


def test_window_union_and_breakdown():
    def ev(name, s, e, dev):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=s, end=e),
            device_type=types.SimpleNamespace(name=dev))
    prof = types.SimpleNamespace(events=lambda: [
        ev("a", 0, 10, "CUDA"), ev("b", 5, 20, "CUDA"), ev("a", 40, 50, "CUDA"),
        ev("host_op", 15, 45, "CPU"), ev("inner", 25, 30, "CPU")])
    win = yardstick.Window(prof, 1e-4)
    assert win.busy_s == pytest.approx(30e-6)
    assert win.device_s(["a"]) == pytest.approx(20e-6)
    b = win.breakdown()
    assert b["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["host_op", pytest.approx(20e-6)]]


def test_numbers_by_hand():
    ref = {"loss": [2.0, 1.0], "grad": {"a": 1.0, "b": 4.0, "c": 1e-9},
           "change": {"a": 2.0, "b": 3.0, "c": 5.0}, "active": [[9, 40], [12, 47]]}
    prog = {"loss": [2.0, 1.1], "grad": {"a": 1.1, "b": 4.0, "c": 7.0},
            "change": {"a": 2.0, "b": 2.7, "c": 0.0}, "active": [[9, 40], [12, 46]]}
    n = check.numbers(prog, ref)
    # c's gradient is under a thousandth of the median leaf's: left out
    assert n["loss_gap"] == pytest.approx(0.1)
    assert n["grad_gap"] == pytest.approx(0.1 / 2.5)
    assert n["change_gap"] == pytest.approx(0.3 / 3.0)
    assert n["active_mismatch"] == 1
    short = dict(prog, active=[[9, 40]])
    assert check.numbers(short, ref)["active_mismatch"] == 1
    m = check.numbers(prog, ref, "median")
    assert m["grad_gap"] == pytest.approx(0.02)      # median of 0.04 and 0
    assert m["change_gap"] == pytest.approx(0.05)    # of 0 and 0.1
    assert check.judge(n, {"loss_gap": 0.2, "active_mismatch": 1})
    assert not check.judge(n, {"loss_gap": 0.05})
    assert not check.judge({"x": float("nan")}, {"x": 1.0})


def test_gap_norm_over_workers():
    w0 = torch.ones(3, 2)
    stacked = torch.stack([w0, w0 + 1, w0 - 2])
    assert check.gap_norm(stacked, w0, block=6) == pytest.approx(
        math.sqrt(6 * 1 + 6 * 4))
