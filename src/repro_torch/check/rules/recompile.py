"""jit-in-loop: compiled or captured callables are built once, not per pass.

The reference's rule flagged ``jax.jit`` constructed inside a loop body:
each iteration gets a fresh callable with an empty compile cache, so
every call compiles.  The port runs eagerly, but the same churn hits
whatever it builds for reuse:

- ``torch.compile(...)`` (each new callable traces and compiles again),
  ``torch.jit.script(...)`` / ``torch.jit.trace(...)``;
- ``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)`` (a capture per
  iteration re-records the work it was meant to replay);
- the kernels' loader, ``kernels.build.build(...)`` / ``build.load(...)``
  (nvcc and a ``ctypes`` load; the loader caches, but a loop around it
  hides a per-pass call on the hot path).

Nothing in the port does this today; the rule guards the CUDA graphs and
compiled paths planned for the dispatch loops.  A ``def`` inside a loop
runs once per call of the outer function, so its body resets the depth,
as in the reference.

``unhashable-static`` / ``loop-varying-static``, the reference's other
findings here, are not ported (``rules.NOT_PORTED``): eager PyTorch has no
static arguments, and the port compiles nothing per shape.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.check.engine import (
    CheckConfig,
    Finding,
    Rule,
    dotted_name,
)

_CONSTRUCTORS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.CUDAGraph",
    "torch.cuda.graph",
    "torch.cuda.make_graphed_callables",
}
# the kernels' loader, under the names the port imports it by
_LOADERS = {"build.build", "build.load", "kernels.build.build",
            "kernels.build.load"}


def _constructed(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name is None:
        return None
    if name in _CONSTRUCTORS or name in _LOADERS:
        return name
    if name.startswith("repro_torch.") and name.endswith(
        tuple("." + loader for loader in _LOADERS)
    ):
        return name
    return None


class CompileInLoopRule(Rule):
    rule_id = "jit-in-loop"

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        findings: List[Finding] = []

        def visit(node: ast.AST, loop_depth: int) -> None:
            for child in ast.iter_child_nodes(node):
                depth = loop_depth
                if isinstance(child, (ast.For, ast.AsyncFor, ast.While)):
                    depth = loop_depth + 1
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                        ast.Lambda)):
                    # a def inside a loop runs once per call of the outer
                    # fn, not per iteration of an enclosing textual loop
                    depth = 0
                if isinstance(child, ast.Call) and depth > 0:
                    name = _constructed(child)
                    if name is not None:
                        findings.append(self._finding(child, path, name))
                visit(child, depth)

        visit(tree, 0)
        return findings

    def _finding(self, call: ast.Call, path: str, name: str) -> Finding:
        return Finding(
            rule=self.rule_id,
            path=path,
            line=call.lineno,
            col=call.col_offset,
            message=(
                f"`{name}(...)` constructed inside a loop body: each "
                "iteration builds (compiles, captures or loads) a fresh "
                "callable instead of reusing one — hoist it out of the loop"
            ),
        )
