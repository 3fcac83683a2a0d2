"""Roofline terms of one rank's program, for the dry run.

The counterpart of the reference's ``repro/launch/hlo_analysis.py``.  The
reference parses XLA's optimised HLO; the port runs eagerly and has no HLO,
so each term comes from elsewhere:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over a trace of
    the rank's program on fake tensors (``FakeTensorMode``: shapes and
    dtypes, no storage, nothing run), so loops count every trip, as the
    reference's trip-count correction makes its parser do.  Matrix
    products only, as the reference counts only ``dot``s;
  * HBM bytes: the reference's proxy, 2× the bytes every operation writes
    (written once, read about once downstream), views excluded, plus the
    program's inputs read once (``count_inputs``);
  * collective bytes: the port's own plan of the sends it makes, by kind,
    each operand's bytes as the reference counts them (``Plan``): the
    replica's all-gather, the gossip sends (``collective-permute``, one per
    ring direction plus the pod edge) and the loss's all-reduce.

Every value is per rank.  The seconds are derived from the constants
below, not measured: ``PEAK_FLOPS`` and ``HBM_BW`` are an NVIDIA H100 SXM's
published dense bf16 rate and memory rate, ``LINK_BW`` its NVLink rate
each way (900 GB/s to the other cards of a host, 450 GB/s each way).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

CARD = "NVIDIA H100 SXM"
PEAK_FLOPS = 989e12       # bf16, dense
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink each way

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


class Plan:
    """The collectives a rank's program makes, recorded by the program as
    it is traced (operand bytes, by kind)."""

    def __init__(self):
        self.bytes_by_kind = {k: 0.0 for k in KINDS}
        self.count_by_kind = {k: 0.0 for k in KINDS}

    def add(self, kind: str, nbytes: float, count: int = 1) -> None:
        self.bytes_by_kind[kind] += float(nbytes) * count
        self.count_by_kind[kind] += count

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_kind),
                               dict(self.count_by_kind))


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _writes(func) -> bool:
    """Whether an operation writes memory of its own: not a view or alias
    of its input (an in-place op writes the input, and counts)."""
    for ret in func._schema.returns:
        info = ret.alias_info
        if info is not None and not info.is_write:
            return False
    return True


class _WrittenBytes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.written = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _writes(func):
            self.written += sum(tensor_bytes(t) for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor))
        return out


def trace_cost(fn: Callable, *args, **kwargs) -> Tuple[float, float, object]:
    """(FLOPs, 2 × bytes written, fn's result) of ``fn(*args)``, run as it
    is (call it on fake tensors, inside ``FakeTensorMode``, for a trace
    that allocates nothing)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    written = _WrittenBytes()
    with counter, written:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), 2.0 * written.written, out


@dataclasses.dataclass
class Roofline:
    """Per-rank-per-step seconds of the three roofline terms, derived from
    the constants above (not measured)."""
    flops: float                 # matmul FLOPs per rank per step
    hbm_bytes: float             # HBM traffic proxy per rank per step
    coll_bytes: float            # collective operand bytes per rank per step
    n_devices: int
    model_flops: float = 0.0     # 6·N·D analytic (global)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / PEAK_FLOPS
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = self.coll_bytes / LINK_BW
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.flops * self.n_devices
        return self.model_flops / tot if tot else 0.0
