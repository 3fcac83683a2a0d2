"""kernel-gate: the plain version of a kernel is reached only by its wrapper.

The reference's rule kept its in-place Pallas scatter behind the
``use_kernel`` TPU flag outside ``kernels/``.  The port's counterpart is
its no-fallback contract: each wrapper of ``repro_torch.kernels``
launches its CUDA kernel on a CUDA tensor (or raises) and runs its plain
PyTorch version only on a CPU tensor, by its own device dispatch.  A
module that called a ``*_plain`` or ``*_ref`` function of the kernels
package directly would run the plain version on the card, where the
kernel belongs, and no launch counter would see it.  So outside
``kernels/``, no module under ``src/`` calls a function whose name ends
in ``_plain`` or ``_ref`` and that it imported from ``repro_torch.kernels``
(by name, or through an imported module).

``pallas-alias``, the reference's other finding here, is not ported
(``rules.NOT_PORTED``): no Pallas alias map exists; the port's in-place
kernels take raw pointers through ctypes, checked at run time by
``kernels/build.py:check_operands``.
"""
from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.check.engine import (
    KERNEL_PACKAGE,
    CheckConfig,
    Finding,
    Rule,
    dotted_name,
)

_PLAIN_SUFFIXES = ("_plain", "_ref")
# the tests and chip_smoke.py hold kernels against their plain versions on
# purpose: the rule holds the program's modules only
_GATED_PATHS = ("src/",)


def _gated(path: str) -> bool:
    norm = "/" + path.replace("\\", "/")
    if "/kernels/" in norm:
        return False
    return any("/" + p in norm for p in _GATED_PATHS)


def _kernel_imports(tree: ast.Module, package: str) -> Dict[str, str]:
    """Local name -> the kernels-package name it was imported as (a
    function or a module)."""
    bound: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            module = node.module or ""
            for alias in node.names:
                full = f"{module}.{alias.name}"
                if full == package or full.startswith(package + "."):
                    bound[alias.asname or alias.name] = alias.name
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == package or alias.name.startswith(package + "."):
                    local = alias.asname or alias.name
                    bound[local] = alias.name
    return bound


class KernelGateRule(Rule):
    rule_id = "kernel-gate"

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        if not _gated(path):
            return []
        bound = _kernel_imports(tree, KERNEL_PACKAGE)
        if not bound:
            return []
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            plain = self._plain_callee(node, bound)
            if plain is None:
                continue
            findings.append(
                Finding(
                    rule=self.rule_id,
                    path=path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"`{plain}` is the plain version of a kernel of "
                        f"`{KERNEL_PACKAGE}`; call its wrapper, which "
                        "runs it only on a CPU tensor and launches (and "
                        "counts) the kernel on a CUDA one (no fallback to "
                        "the plain version on the card)"
                    ),
                )
            )
        return findings

    @staticmethod
    def _plain_callee(call: ast.Call, bound: Dict[str, str]) -> str | None:
        name = dotted_name(call.func)
        if name is None:
            return None
        parts = name.split(".")
        if len(parts) == 1:
            # a function imported by name (perhaps renamed)
            original = bound.get(parts[0])
            if original is not None and original.endswith(_PLAIN_SUFFIXES):
                return name
            return None
        # module.attr...: the module (or its package) imported from kernels
        for i in range(len(parts) - 1, 0, -1):
            if ".".join(parts[:i]) in bound:
                if parts[-1].endswith(_PLAIN_SUFFIXES):
                    return name
                return None
        return None
