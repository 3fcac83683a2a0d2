"""The yardstick: the card's peaks, the model's operations, and the
reduction of a profiled window to device time, busy share and breakdown.

Peaks are NVIDIA's published dense rates of one H100 SXM at its 700 W
limit: 989 TFLOP/s for bf16 operands, 495 TFLOP/s for float32 operands
(TF32, the card's highest float32 rate, so no float32-accurate product
can read above 100 %), 3.35 TB/s of HBM.

The trace arithmetic (device events, the union of their spans) is the
program's ``profiling.device_events`` / ``busy_ms`` copied, so that later
changes to the program cannot move it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int]:
    """(L, d, H, KV, dh, f) of a dense configuration."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return (cfg["num_hidden_layers"], d, H, cfg["num_key_value_heads"],
            cfg.get("head_dim") or d // H, cfg["intermediate_size"])


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a product per token: every layer's projections
    and the unembedding (the tied table counted once, as the head)."""
    L, d, H, KV, dh, f = dims(cfg)
    per_layer = d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * f
    return L * per_layer + d * cfg["vocab_size"]


def train_flops(cfg: dict, seq_len: int, tokens: int) -> float:
    """Model FLOPs of forward and backward over ``tokens`` tokens in
    sequences of ``seq_len``: 6 per matmul parameter per token, plus causal
    attention's 6·L·d·T per token (its QKᵀ and PV over the half of the
    T×T scores a causal mask keeps, three times for the backward).
    Recomputation is not counted."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    return tokens * (6.0 * matmul_params(cfg) + 6.0 * L * d * seq_len)


def bound_s(bytes_: float, flops: float, dtype: str) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak, whichever is larger."""
    return max(bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# -- a profiled window ----------------------------------------------------------

class Window:
    """A profiled window reduced to what the metric readers take: the device
    events as (name, start µs, end µs), the host operators likewise where
    they were recorded, and the window's host-clock seconds."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        self.device: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for name, start, end, device in _events(prof):
            (self.device if device else self.host).append((name, start, end))
        self.device.sort(key=lambda r: r[1])
        self._spans = _union([(s, e) for _, s, e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._spans) / 1e6

    def device_s(self, patterns) -> Optional[float]:
        """Device seconds of the events whose name holds any of
        ``patterns``, or None where none ran."""
        spans = [(s, e) for n, s, e in self.device
                 if any(p in n for p in patterns)]
        if not spans:
            return None
        return sum(e - s for s, e in _union(spans)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the device named by the innermost host operator running at
        the gap's start (or by their offset in the window where the host
        was not recorded), as [name, seconds]."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            by_name[n] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in
                       zip(self._spans, self._spans[1:])), reverse=True)[:top]
        t0 = self._spans[0][0] if self._spans else 0.0
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._host_at(at, t0), g / 1e6]
                              for g, at in gaps]}

    def _host_at(self, t: float, t0: float) -> str:
        best = None
        for n, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        if best is not None:
            return best[0]
        what = "no host operator" if self.host else "host not traced"
        return f"{what}, at {(t - t0) / 1e6:.6f} s"


def _events(prof):
    """(name, start µs, end µs, on the device) of every event of a profiled
    window: from the profiler's raw results where it has them (a
    training step's 1.6 M kernels take seconds there, minutes as the
    ``FunctionEvent`` tree of ``prof.events()``), else from
    ``prof.events()``."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        for e in prof.events():
            if e.time_range.end > 0:
                yield (e.name, e.time_range.start, e.time_range.end,
                       e.device_type.name == "CUDA")
        return
    base = None
    for e in raw.events():
        if e.duration_ns() <= 0:
            continue
        base = e.start_ns() if base is None else base
        start = (e.start_ns() - base) / 1e3       # exact ns before floats
        yield (e.name(), start, start + e.duration_ns() / 1e3,
               e.device_type().name == "CUDA")


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
