"""Rule registry for repro_torch.check.

Each of the reference's ten rule ids is either ported with its torch
meaning (the ids of :func:`default_rules`) or listed in
:data:`NOT_PORTED` with the reason it has none.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.check.engine import Rule
from repro_torch.check.rules.aliasing import KernelGateRule
from repro_torch.check.rules.donation import AliasBreakRule
from repro_torch.check.rules.host_sync import HostSyncRule
from repro_torch.check.rules.recompile import CompileInLoopRule
from repro_torch.check.rules.rng_order import RngOrderRule

__all__ = [
    "AliasBreakRule",
    "CompileInLoopRule",
    "HostSyncRule",
    "KernelGateRule",
    "NOT_PORTED",
    "RngOrderRule",
    "default_rules",
]

NOT_PORTED: Dict[str, str] = {
    "use-after-donate": (
        "an in-place block leaves its operand valid, and reading it after "
        "the call is the point; the alias hazard is missing-alias-break"
    ),
    "pallas-alias": (
        "no Pallas alias map exists; the port's in-place kernels take raw "
        "pointers through ctypes, checked at run time by "
        "kernels/build.py:check_operands"
    ),
    "unhashable-static": (
        "eager PyTorch has no static arguments, and the port compiles "
        "nothing per shape"
    ),
    "loop-varying-static": (
        "eager PyTorch has no static arguments, and the port compiles "
        "nothing per shape"
    ),
}


def default_rules() -> List[Rule]:
    """Fresh instances of every registered rule (rules are stateless, but a
    fresh list keeps callers free to mutate it)."""
    return [
        AliasBreakRule(),
        KernelGateRule(),
        HostSyncRule(),
        RngOrderRule(),
        CompileInLoopRule(),
    ]
