"""The comparison that decides ``correct``: the program's readings of its
first steps against the plain reference's, each number beside its limit.
A step is a training step, or a simulator's ``run`` call.

Readings of one side:

- ``loss``: the cell's own losses, in order (a training step's; every
  history row's of a simulator's call);
- ``grad``: {leaf: ‖update of step 1‖}, the first step's change of the
  parameters before any later step, the gradient as the update applies it;
- ``change``: {leaf: ‖W_k − W_0‖} after the last of the first steps;
- ``active`` (simulator cells): per row of a call's history, [its last
  event's index, the workers active over its events, summed].

Norms are taken over every worker of a stacked leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's take no
part (rounding alone moves them).  A gap of norms is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger.
A cell compares the worst leaf's gap, or, where its limits file says
``"leaf_gap": "median"``, the median leaf's: float32 norm scales, at 1.0,
resolve a small change only to their ulp, so their gap swings from seed
to seed by a factor of 30 while every other leaf's holds steady.
"""
from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List

import torch

SMALL_LEAF = 1e-3


def gap_norm(stacked: torch.Tensor, w0: torch.Tensor,
             block: int = 1 << 26) -> float:
    """‖stacked[i] − w0‖ over every worker i (``stacked``: (N, ...)),
    summed in float64 (a float32 sum of millions of squares is off by
    parts in 10⁴ on the CPU), ``block`` elements at a time."""
    n = stacked.shape[0]
    flat, w = stacked.reshape(n, -1), w0.reshape(1, -1)
    D = w.shape[1]
    rows, cols = max(1, block // max(1, D)), min(D, block)
    sq = torch.zeros((), dtype=torch.float64, device=w0.device)
    for i in range(0, n, rows):
        for a in range(0, D, cols):
            d = (flat[i:i + rows, a:a + cols].to(torch.float64)
                 - w[:, a:a + cols].to(torch.float64))
            sq += (d * d).sum()
    return math.sqrt(float(sq))


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str], over: str) -> float:
    """The worst (``over`` "worst") or the median ("median") leaf's gap; a
    leaf the program did not report reads NaN, which fails any limit."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = [abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], med)
            for k in leaves]
    if any(map(math.isnan, gaps)):
        return math.nan
    return max(gaps) if over == "worst" else statistics.median(gaps)


def numbers(prog: dict, ref: dict, over: str = "worst") -> Dict[str, float]:
    """The compared numbers of one run: the worst step's relative loss gap,
    the worst (or, with ``over`` "median", the median) leaf's gaps of the
    first update's and of the change's norms, and, where the cell has
    active sets, by how much the two sides' history rows differ: in
    number, in last event and in workers active, summed."""
    med = statistics.median(ref["grad"].values())
    leaves = [k for k, v in ref["grad"].items() if v >= SMALL_LEAF * med]
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss_gap": (math.nan if any(map(math.isnan, loss))
                        or len(loss) < len(ref["loss"]) else max(loss)),
           "grad_gap": _leaf_gap(prog["grad"], ref["grad"], leaves, over),
           "change_gap": _leaf_gap(prog["change"], ref["change"], leaves,
                                   over)}
    if "active" in ref:
        pa, ra = prog["active"], ref["active"]
        out["active_mismatch"] = float(abs(len(pa) - len(ra)) + sum(
            abs(p[0] - r[0]) + abs(p[1] - r[1]) for p, r in zip(pa, ra)))
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(nums[k] <= limits[k] for k in limits)


def report(nums: Dict[str, float], limits: Dict[str, float],
           stream=None) -> Dict[str, dict]:
    """Print each number beside its limit on standard error, one a line,
    and return them for the result's ``checks`` key."""
    stream = stream or sys.stderr
    out = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    for k, v in out.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=stream)
    stream.flush()
    return out
