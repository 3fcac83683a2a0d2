"""missing-alias-break: a carry fed to an in-place block owns its storage.

The reference donated its ``(W, S, y, ptr)`` carry to compiled blocks
(``donate_argnums``) and broke the ``same_init`` alias of W and S with
``jax.tree.map(jnp.array, ...)`` before the first dispatch.  The port
updates the carry in place where the reference donated it: the fused
block (``FusedPairBlock``, held as the runner's ``_pair_block``) and the
active-set update (``sparse_event_update`` → ``scatter_active_rows``,
``index_copy_`` or the ``scatter_rows`` kernel) write rows of W and S
through their operands.  If S was bound from W without a copy
(``self.S = self.W``, ``self.S = dict(self.W)``, ``{k: v for k, v in
W.items()}``, ``W[k].detach()``, ...), the two names share storage and
each in-place update corrupts the other — silently, since both stay
finite.  The runner breaks the alias with ``.clone()`` (``core/runner.py``
``__init__``, and the warm-up's clones).

This rule flags, in every scope that builds or feeds one of
``CheckConfig.inplace_blocks`` (a call to one, or an assignment binding
one; the scope is the class for a method, so the constructor that makes
the carries is held too, else the function), an assignment that binds
one of ``CheckConfig.carry_names`` from *another* carry name through an
expression that keeps its storage: the bare name, ``dict`` / ``list`` /
``tuple`` / ``copy.copy`` of it, its ``.copy()`` / ``.detach()`` /
``.view()`` / ``.reshape()`` / ``.contiguous()`` / ..., or a dict
comprehension over its ``.items()`` whose values are such views.  A
``.clone()`` (or ``torch.clone``, ``copy.deepcopy``) anywhere in the
value breaks the alias.

``use-after-donate``, the reference's other donation finding, is not
ported (``rules.NOT_PORTED``): an in-place block leaves its operand valid,
and reading it after the call is the point.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from repro_torch.check.engine import (
    CheckConfig,
    Finding,
    Rule,
    call_suffix,
    dotted_name,
)

# wrappers that copy the container but share every tensor in it
_SHALLOW_CALLS = {"dict", "list", "tuple", "copy.copy", "copy"}
# tensor / container methods whose result may share the receiver's storage
_VIEW_METHODS = {
    "copy", "detach", "view", "view_as", "reshape", "expand", "expand_as",
    "contiguous", "as_strided", "squeeze", "unsqueeze", "flatten", "to",
    "narrow", "t", "transpose", "permute",
}
_CLONES = {"clone", "deepcopy"}


def _carry(node: ast.AST, config: CheckConfig) -> str | None:
    """The carry name a Name/Attribute refers to (``self.W`` -> 'W')."""
    name = dotted_name(node)
    if name is None:
        return None
    last = name.rsplit(".", 1)[-1]
    return last if last in config.carry_names else None


def _aliased_carry(value: ast.AST, config: CheckConfig) -> str | None:
    """The carry whose storage ``value`` keeps, or None."""
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call) and call_suffix(sub) in _CLONES:
            return None
    return _alias_of(value, config)


def _alias_of(value: ast.AST, config: CheckConfig) -> str | None:
    if isinstance(value, (ast.Name, ast.Attribute)):
        return _carry(value, config)
    if isinstance(value, ast.Subscript):
        return _alias_of(value.value, config)
    if isinstance(value, ast.Call):
        callee = dotted_name(value.func)
        if callee in _SHALLOW_CALLS and len(value.args) == 1:
            return _alias_of(value.args[0], config)
        if isinstance(value.func, ast.Attribute) and value.func.attr in _VIEW_METHODS:
            return _alias_of(value.func.value, config)
        return None
    if isinstance(value, ast.DictComp) and len(value.generators) == 1:
        gen = value.generators[0]
        it = gen.iter
        if not (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Attribute)
            and it.func.attr in ("items", "values")
        ):
            return None
        source = _alias_of(it.func.value, config)
        if source is None:
            return None
        loop_vars = {n.id for n in ast.walk(gen.target) if isinstance(n, ast.Name)}
        return source if _is_view_of(value.value, loop_vars) else None
    return None


def _is_view_of(node: ast.AST, names: set[str]) -> bool:
    """Is ``node`` one of ``names`` (or a view of one, or an item of one)?"""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Subscript):
        return _is_view_of(node.value, names)
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _VIEW_METHODS
    ):
        return _is_view_of(node.func.value, names)
    return False


def _pairs(target: ast.expr, value: ast.expr) -> Iterator[Tuple[ast.expr, ast.expr]]:
    """(target, value) pairs of an assignment, tuples unpacked elementwise."""
    if (
        isinstance(target, (ast.Tuple, ast.List))
        and isinstance(value, (ast.Tuple, ast.List))
        and len(target.elts) == len(value.elts)
    ):
        for t, v in zip(target.elts, value.elts):
            yield from _pairs(t, v)
    else:
        yield target, value


def _own_nodes(fn: ast.AST) -> List[ast.AST]:
    """Nodes of ``fn``'s body, nested defs' bodies excluded."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _touches_block(nodes: List[ast.AST], config: CheckConfig) -> bool:
    """Does any node call or bind one of the in-place blocks?"""
    for node in nodes:
        if isinstance(node, ast.Call) and call_suffix(node) in config.inplace_blocks:
            return True
        if isinstance(node, ast.Assign):
            for target in node.targets:
                for sub in ast.walk(target):
                    name = dotted_name(sub)
                    if name is not None and (
                        name.rsplit(".", 1)[-1] in config.inplace_blocks
                    ):
                        return True
    return False


class AliasBreakRule(Rule):
    rule_id = "missing-alias-break"

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        findings: List[Finding] = []
        for scope in self._scopes(tree):
            nodes = [n for fn in scope for n in _own_nodes(fn)]
            if not _touches_block(nodes, config):
                continue
            for node in nodes:
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    for t, v in _pairs(target, node.value):
                        dst, src = _carry(t, config), _aliased_carry(v, config)
                        if dst is not None and src is not None and src != dst:
                            findings.append(self._finding(t, v, src, path, config))
        return findings

    @staticmethod
    def _scopes(tree: ast.Module) -> Iterator[List[ast.AST]]:
        """Each class's methods together; each other function alone."""
        methods: set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                fns = [
                    m for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                ]
                methods.update(id(m) for m in fns)
                yield list(fns)
        for node in ast.walk(tree):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and id(node) not in methods
            ):
                yield [node]

    def _finding(
        self, target: ast.expr, value: ast.expr, src: str, path: str,
        config: CheckConfig,
    ) -> Finding:
        dst = dotted_name(target)
        return Finding(
            rule=self.rule_id,
            path=path,
            line=value.lineno,
            col=value.col_offset,
            message=(
                f"`{dst}` is bound from the carry `{src}` without a copy, in "
                "a scope that feeds an in-place block "
                f"({', '.join(config.inplace_blocks)}); with same_init the "
                "two share storage and each in-place update corrupts the "
                "other — break the alias with `.clone()` "
                "(see runner.__init__)"
            ),
        )
