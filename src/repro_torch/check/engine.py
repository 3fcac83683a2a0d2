"""The lint engine of the port: rule protocol, pragmas, config, file walking.

The port of the reference's ``repro/check/engine.py``.  A :class:`Rule`
owns one invariant.  The engine parses each file once, hands the module
AST to every enabled rule, collects :class:`Finding` objects, and drops any
finding whose line carries a ``# repro: disable=<rule>`` pragma (or the
blanket ``# repro: disable``).  The pragma is the reference's, so one
comment serves both lints.  Pragmas attach to the physical line of the
flagged node, so they read exactly like ``# noqa`` / ``# type: ignore``
comments.

Per-rule configuration rides in :class:`CheckConfig`: path excludes (the
reference's seeded-violation fixtures under ``tests/fixtures/check`` must
not fail the repo-wide run), the host-sync scopes (the reference's regexes:
the port keeps its dispatch functions' names), and, in place of the
reference's donation tables, the port's in-place blocks and carries.
Everything has working defaults for this repository; tests construct
bespoke configs.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Sequence, Set, Tuple

_PRAGMA_RE = re.compile(r"#\s*repro:\s*disable(?:=(?P<rules>[\w,\-]+))?")
# the package of the port's kernel wrappers (host-sync, kernel-gate)
KERNEL_PACKAGE = "repro_torch.kernels"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CheckConfig:
    """Engine + rule configuration (defaults match this repository).

    ``host_sync_scopes`` are regexes selecting the function names whose
    bodies count as block-dispatch loops for the host-sync rule.
    ``rng_surface_attr`` is the class attribute a scheduler uses to declare
    its sampler surface for the rng-order rule.  ``inplace_blocks`` names
    the callables that update their operands in place (the port's
    counterpart of the reference's donating blocks) and ``carry_names``
    the carries that ``same_init`` starts equal: the missing-alias-break
    rule holds every scope that builds or feeds such a block to binding
    one carry from another only through ``.clone()``.
    """

    enabled_rules: Tuple[str, ...] = ()  # empty = all registered rules
    exclude: Tuple[str, ...] = ("tests/fixtures/",)
    host_sync_scopes: Tuple[str, ...] = (
        r"^_dispatch_\w+$",
        r"^_run_scan$",
        r"^_run_sparse_stream$",
        r"^_run_fused$",
        r"^_record_eval$",
        r"^_fused_record$",
        r"^_warn_pool_wrap$",
        r"^warmup$",
        # virtual-time tracing (obs/trace.py): the drain is the one
        # sanctioned host fetch per traced run; the recorders run on the
        # hot dispatch path and must stay sync-free
        r"^_trace_summary$",
        r"^drain_fused_payload$",
        r"^record_(event|events|sparse|chunk|fused)$",
    )
    rng_surface_attr: str = "rng_methods"
    # the fused generate-and-consume block (core/fused.py, runner.py) and
    # the active-set update that scatters rows into (W, S) in place
    # (core/aau.py, kernels/sparse_gossip/ops.py)
    inplace_blocks: Tuple[str, ...] = (
        "_pair_block",
        "sparse_event_update",
        "scatter_active_rows",
    )
    carry_names: Tuple[str, ...] = ("W", "S")

    def rule_enabled(self, rule_id: str) -> bool:
        return not self.enabled_rules or rule_id in self.enabled_rules

    def path_excluded(self, path: str) -> bool:
        norm = path.replace("\\", "/")
        return any(part in norm for part in self.exclude)


class Rule:
    """Base class for one lint rule family.

    Subclasses set ``rule_id`` (+ optionally ``aliases`` for findings they
    emit under secondary ids — pragma suppression honours the finding's own
    id) and implement :meth:`check`, returning findings for one module.
    """

    rule_id: str = ""
    aliases: Tuple[str, ...] = ()

    def check(
        self, tree: ast.Module, path: str, config: CheckConfig
    ) -> List[Finding]:
        raise NotImplementedError

    def ids(self) -> Tuple[str, ...]:
        return (self.rule_id, *self.aliases)


def _disabled_rules_by_line(source: str) -> Dict[int, Set[str]]:
    """Map line number -> set of rule ids disabled there ('*' = all).

    Uses the token stream rather than a per-line regex so pragmas inside
    string literals don't suppress anything.
    """
    disabled: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(iter(source.splitlines(True)).__next__)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = m.group("rules")
            ids = {"*"} if rules is None else {r.strip() for r in rules.split(",")}
            disabled.setdefault(tok.start[0], set()).update(ids)
    except tokenize.TokenError:
        pass
    return disabled


def check_source(
    source: str,
    path: str,
    config: CheckConfig | None = None,
    rules: Sequence[Rule] | None = None,
) -> List[Finding]:
    """Lint one file's source text; returns pragma-filtered findings."""
    from repro_torch.check.rules import default_rules

    cfg = config if config is not None else CheckConfig()
    active = [
        r
        for r in (rules if rules is not None else default_rules())
        if cfg.rule_enabled(r.rule_id)
    ]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [
            Finding(
                rule="parse-error",
                path=path,
                line=exc.lineno or 1,
                col=exc.offset or 0,
                message=f"could not parse: {exc.msg}",
            )
        ]
    disabled = _disabled_rules_by_line(source)
    findings: List[Finding] = []
    for rule in active:
        findings.extend(rule.check(tree, path, cfg))
    kept = []
    for f in findings:
        at_line = disabled.get(f.line, set())
        if "*" in at_line or f.rule in at_line:
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def iter_python_files(paths: Iterable[str], config: CheckConfig) -> Iterator[Path]:
    for entry in paths:
        p = Path(entry)
        if p.is_file() and p.suffix == ".py":
            if not config.path_excluded(str(p)):
                yield p
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if "__pycache__" in sub.parts:
                    continue
                if config.path_excluded(str(sub)):
                    continue
                yield sub


def check_paths(
    paths: Sequence[str],
    config: CheckConfig | None = None,
    rules: Sequence[Rule] | None = None,
) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    cfg = config if config is not None else CheckConfig()
    findings: List[Finding] = []
    for file in iter_python_files(paths, cfg):
        try:
            source = file.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as exc:
            findings.append(
                Finding(
                    rule="read-error",
                    path=str(file),
                    line=1,
                    col=0,
                    message=str(exc),
                )
            )
            continue
        findings.extend(check_source(source, str(file), cfg, rules))
    return findings


# --- shared AST helpers used by several rules -------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` -> 'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_suffix(call: ast.Call) -> str | None:
    """The final dotted component of a call's callee (``self._pair_block``
    -> '_pair_block'), or None for non-name callees."""
    name = dotted_name(call.func)
    if name is None:
        return None
    return name.rsplit(".", 1)[-1]


def walk_functions(
    tree: ast.Module,
) -> Iterator[Tuple[ast.FunctionDef | ast.AsyncFunctionDef, List[ast.AST]]]:
    """Yield (function node, ancestor stack) for every function in the module."""

    def _walk(node: ast.AST, stack: List[ast.AST]) -> Iterator[
        Tuple[ast.FunctionDef | ast.AsyncFunctionDef, List[ast.AST]]
    ]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, stack
                yield from _walk(child, stack + [child])
            elif isinstance(child, ast.ClassDef):
                yield from _walk(child, stack + [child])
            else:
                yield from _walk(child, stack)

    yield from _walk(tree, [])
