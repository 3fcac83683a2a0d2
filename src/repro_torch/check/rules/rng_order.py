"""rng-order: every scheduler RNG draw routes through a declared surface.

The port of the reference's rule.  The bit-exact event streams are a
*draw-order* contract: per_event ≡ scan ≡ sparse_scan ≡ fused hold, and
the port replays the reference's streams, because each scheduler consumes
its ``np.random.default_rng(seed)`` stream in one canonical order (the
port's host modules are copies of the reference's).  A draw added anywhere
else silently forks the stream, and every equivalence test downstream
starts comparing different trajectories.  The same holds for a
``torch.Generator`` a class owns.

The contract is made machine-checkable by declaration: any class that owns
a generator (assigns ``self._rng`` / ``self.rng`` from
``np.random.default_rng(...)`` or ``torch.Generator(...)``) must carry a
class attribute (default name ``rng_methods``) listing the methods allowed
to draw from it.  This rule flags

- ``rng-order``: an owning class with no surface declaration, or a draw in
  a method outside the declared surface — ``self._rng.<draw>()`` /
  ``self.rng.<draw>()``, or a call that passes ``generator=self._rng``
  (``__init__`` is implicitly allowed: construction draws are pinned by
  the constructor seed);
- ``global-rng``: any ``np.random.<fn>()`` draw through NumPy's legacy
  global generator (``np.random.default_rng`` / ``Generator`` /
  ``SeedSequence`` construction is the sanctioned use of the namespace),
  and any draw from torch's global generator: ``torch.rand`` /
  ``randn`` / ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
  ``multinomial`` / ``poisson`` and their ``*_like`` forms, or the
  in-place ``Tensor.uniform_`` / ``normal_`` / ``bernoulli_`` /
  ``random_`` / ``exponential_`` / ..., each called with no
  ``generator=``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from repro_torch.check.engine import (
    CheckConfig,
    Finding,
    Rule,
    dotted_name,
)

_RNG_ATTRS = ("_rng", "rng")
_SELF_RNG = tuple(f"self.{a}" for a in _RNG_ATTRS)
_GLOBAL_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "Philox"}
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
}
_TENSOR_DRAWS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "log_normal_", "geometric_",
}


def _generator_kw(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "generator":
            return kw.value
    return None


def _constructs_generator(value: ast.AST) -> bool:
    """``np.random.default_rng(...)`` / ``torch.Generator(...)``, also
    followed by ``.manual_seed(...)``."""
    while isinstance(value, ast.Call):
        callee = dotted_name(value.func)
        if callee is not None and (
            callee.endswith("default_rng")
            or (callee.startswith("torch") and callee.endswith("Generator"))
        ):
            return True
        if isinstance(value.func, ast.Attribute) and value.func.attr == "manual_seed":
            value = value.func.value
            continue
        return False
    return False


def _owns_rng(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _constructs_generator(node.value):
            for target in node.targets:
                if dotted_name(target) in _SELF_RNG:
                    return True
    return False


def _declared_surface(
    cls: ast.ClassDef, attr: str
) -> Optional[Tuple[int, Set[str]]]:
    """(decl line, method names) of the class-level surface attr, if any."""
    for stmt in cls.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            target, value = stmt.target, stmt.value
        else:
            continue
        if isinstance(target, ast.Name) and target.id == attr:
            try:
                val = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                return stmt.lineno, set()
            if isinstance(val, (tuple, list, set, frozenset)):
                return stmt.lineno, {str(v) for v in val}
    return None


def _global_draw(call: ast.Call) -> str | None:
    """The name of a draw from NumPy's or torch's global generator."""
    name = dotted_name(call.func)
    if name is not None:
        parts = name.split(".")
        if (
            len(parts) == 3
            and parts[0] in ("np", "numpy")
            and parts[1] == "random"
            and parts[2] not in _GLOBAL_OK
        ):
            return name
        if (
            len(parts) == 2
            and parts[0] == "torch"
            and parts[1] in _TORCH_DRAWS
            and _generator_kw(call) is None
        ):
            return name
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _TENSOR_DRAWS
        and _generator_kw(call) is None
    ):
        return name or f"Tensor.{call.func.attr}"
    return None


class RngOrderRule(Rule):
    rule_id = "rng-order"
    aliases = ("global-rng",)

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        findings: List[Finding] = []
        findings.extend(self._check_global_draws(tree, path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(node, path, config))
        return findings

    def _check_global_draws(self, tree: ast.Module, path: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _global_draw(node)
            if name is None:
                continue
            torch_draw = not name.startswith(("np.", "numpy."))
            findings.append(
                Finding(
                    rule="global-rng",
                    path=path,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"`{name}` draws from torch's global generator; pass "
                        "`generator=` a seeded `torch.Generator` so the "
                        "stream stays pinned"
                        if torch_draw else
                        f"`{name}` draws from numpy's global generator; "
                        "streams must come from a per-scheduler "
                        "`np.random.default_rng(seed)` to stay pinned"
                    ),
                )
            )
        return findings

    def _check_class(
        self, cls: ast.ClassDef, path: str, config: CheckConfig
    ) -> List[Finding]:
        surface = _declared_surface(cls, config.rng_surface_attr)
        owns = _owns_rng(cls)
        if not owns and surface is None:
            return []
        findings: List[Finding] = []
        if owns and surface is None:
            findings.append(
                Finding(
                    rule=self.rule_id,
                    path=path,
                    line=cls.lineno,
                    col=cls.col_offset,
                    message=(
                        f"class `{cls.name}` owns an RNG (assigns self._rng) "
                        f"but declares no sampler surface; add "
                        f"`{config.rng_surface_attr} = (<draw methods>,)` so "
                        "the draw-order contract is machine-checked"
                    ),
                )
            )
            return findings
        assert surface is not None
        _line, allowed = surface
        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if method.name == "__init__" or method.name in allowed:
                continue
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                draw = self._own_draw(node)
                if draw is None:
                    continue
                findings.append(
                    Finding(
                        rule=self.rule_id,
                        path=path,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"raw `{draw}` draw in "
                            f"`{cls.name}.{method.name}`, which is not in "
                            f"the declared sampler surface "
                            f"{sorted(allowed)}; route it through a "
                            "declared method or extend the surface "
                            "(draw order is the bit-exact contract)"
                        ),
                    )
                )
        return findings

    @staticmethod
    def _own_draw(call: ast.Call) -> str | None:
        """``self._rng.<draw>()`` or ``f(..., generator=self._rng)``."""
        name = dotted_name(call.func)
        if name is not None:
            parts = name.split(".")
            if len(parts) == 3 and parts[0] == "self" and parts[1] in _RNG_ATTRS:
                return f"self.{parts[1]}.{parts[2]}()"
        gen = _generator_kw(call)
        if gen is not None and dotted_name(gen) in _SELF_RNG:
            return f"{name or '<call>'}(generator={dotted_name(gen)})"
        return None
