"""host-sync: no implicit device→host transfers in block dispatch.

The port of the reference's rule, and the static twin of
:func:`repro_torch.check.runtime.host_conversion_guard`.  The
block-dispatch loops are the hot host path: one queue of device work per
block, everything else stays on the card.  An implicit transfer —
``float()``, ``int()``, ``bool()``, ``complex()``, ``np.asarray`` /
``np.array``, ``.item()``, ``.tolist()``, ``.numpy()`` or ``.cpu()``
applied to a tensor — waits for the card inside the loop, as it waited for
the TPU in the reference.  The sanctioned form is one *explicit*
:func:`repro_torch.check.runtime.fetch` per block (batched,
self-documenting, and legal under the runtime sanitizer); everything
downstream of it is host data and passes this rule.

A value counts as a tensor when it comes from a ``torch.*`` call (less the
namespaces that return host objects: ``torch.cuda``, ``torch.device``,
``torch.finfo``, ...), from a wrapper of ``repro_torch.kernels``,
from a tensor method of such a value (``x.sum()``; not the metadata
methods ``numel``, ``size``, ``dim``, ...), or from a local name bound to
one earlier in the scope.

The rule only looks inside the dispatch-loop scopes configured in
``CheckConfig.host_sync_scopes`` (function-name regexes, the reference's:
the port keeps its dispatch functions' names): eval-time or drain-time
syncs outside the loops are deliberate and cheap.
"""
from __future__ import annotations

import ast
import re
from typing import List, Set

from repro_torch.check.engine import (
    KERNEL_PACKAGE,
    CheckConfig,
    Finding,
    Rule,
    dotted_name,
    walk_functions,
)

_CONVERTERS = {"float", "int", "bool", "complex"}
_NP_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# Tensor methods that copy to the host (and wait for the card).
_SYNC_METHODS = ("item", "tolist", "numpy", "cpu")
# Tensor methods that read host-side metadata: no transfer, host results.
_METADATA_METHODS = {
    "numel", "nelement", "size", "dim", "ndimension", "stride",
    "element_size", "data_ptr", "is_contiguous", "get_device",
    "storage_offset",
}
# ``torch.*`` callables that return host objects, by name prefix.
_HOST_TORCH = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.device", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.is_tensor", "torch.get_", "torch.set_", "torch.promote_types",
    "torch.Generator",
)
# The explicit fetch: values produced by it are host data.
_SANCTIONED_SUFFIX = "fetch"


def _kernel_names(tree: ast.Module, package: str) -> Set[str]:
    """Local names bound by imports from the kernels package (its wrapper
    functions and its modules)."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            module = node.module or ""
            if module == package or module.startswith(package + "."):
                names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(package + ".") and alias.asname:
                    names.add(alias.asname)
    return names


class _Taint:
    """Which expressions of one scope hold a tensor."""

    def __init__(self, kernel_names: Set[str]) -> None:
        self.kernel_names = kernel_names
        self.derived: Set[str] = set()

    def holds_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Call):
            return self._call_holds_tensor(node)
        if isinstance(node, ast.Name):
            return node.id in self.derived
        if isinstance(node, ast.Attribute):
            name = dotted_name(node)
            return name in self.derived if name is not None else False
        if isinstance(node, ast.BinOp):
            return self.holds_tensor(node.left) or self.holds_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.holds_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return self.holds_tensor(node.left) or any(
                self.holds_tensor(c) for c in node.comparators
            )
        if isinstance(node, ast.Subscript):
            return self.holds_tensor(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.holds_tensor(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.holds_tensor(node.body) or self.holds_tensor(node.orelse)
        return False

    def _call_holds_tensor(self, node: ast.Call) -> bool:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_METHODS or func.attr in _METADATA_METHODS:
                return False
            if self.holds_tensor(func.value):
                return True
        name = dotted_name(func)
        if name is not None:
            if name.rsplit(".", 1)[-1] == _SANCTIONED_SUFFIX:
                return False
            if name.split(".", 1)[0] == "torch":
                return not name.startswith(_HOST_TORCH)
            if name.split(".", 1)[0] in self.kernel_names:
                return True
        # np.max(tensor) etc. converts its argument: propagate through args
        return any(self.holds_tensor(a) for a in node.args)


class HostSyncRule(Rule):
    rule_id = "host-sync"

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        scopes = [re.compile(p) for p in config.host_sync_scopes]
        kernel_names = _kernel_names(tree, KERNEL_PACKAGE)
        findings: List[Finding] = []
        for fn, _stack in walk_functions(tree):
            if not any(p.match(fn.name) for p in scopes):
                continue
            findings.extend(self._check_scope(fn, path, _Taint(kernel_names)))
        return findings

    def _check_scope(
        self, fn: ast.FunctionDef | ast.AsyncFunctionDef, path: str,
        taint: _Taint,
    ) -> List[Finding]:
        # one linear pass in source order so taint propagates through
        # local assignments (``x = torch.max(...); float(x)``)
        findings: List[Finding] = []
        nodes = sorted(
            (n for n in ast.walk(fn) if hasattr(n, "lineno")),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in nodes:
            if isinstance(node, ast.Assign):
                tensor = taint.holds_tensor(node.value)
                for target in node.targets:
                    name = dotted_name(target)
                    if name is None:
                        continue
                    if tensor:
                        taint.derived.add(name)
                    else:
                        taint.derived.discard(name)
            elif isinstance(node, ast.Call):
                finding = self._check_call(node, taint, path)
                if finding is not None:
                    findings.append(finding)
        return findings

    def _check_call(
        self, node: ast.Call, taint: _Taint, path: str
    ) -> Finding | None:
        # x.item() / x.tolist() / x.numpy() / x.cpu() on a tensor receiver
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and taint.holds_tensor(node.func.value)
        ):
            return self._finding(node, path, f".{node.func.attr}()")
        name = dotted_name(node.func)
        if name is None:
            return None
        is_converter = name in _CONVERTERS or name in _NP_CONVERTERS
        if not is_converter or not node.args:
            return None
        if taint.holds_tensor(node.args[0]):
            return self._finding(node, path, f"{name}()")
        return None

    def _finding(self, node: ast.Call, path: str, what: str) -> Finding:
        return Finding(
            rule=self.rule_id,
            path=path,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"implicit device→host sync via {what} on a tensor inside "
                "a block-dispatch scope; fetch once with an explicit "
                "`repro_torch.check.runtime.fetch(...)` instead (the host "
                "waits for the card, and the runtime sanitizer rejects it)"
            ),
        )
