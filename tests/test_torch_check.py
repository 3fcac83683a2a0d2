"""The port's static lint (``repro_torch.check``) against the reference's.

Each ported rule id has a seeded violation on its ``# expect: <rule>``
line and a pragma-suppressed twin in the fixtures below (string literals,
written to ``tmp_path`` where a file is needed); the finding set must
equal the expectation set, as ``tests/test_check.py`` asserts for the
reference's.  Every one of the reference's ten ids is ported or listed in
``NOT_PORTED`` with its reason.

Parity with the reference, which stays as it is: the NumPy rules give
exactly its findings on its own ``rng_order_violations.py``; a torch
translation of its ``host_sync_violations.py`` is flagged on the same
lines; pragmas, ``parse-error``, rule selection and the default exclude
behave alike; the text and JSON reports are byte-identical; the CLI exits
0, 1 and 2.  The gate: the repository (``src``, ``tests``,
``benchmarks``, ``chip_smoke.py``) lints clean under the port's rules.
"""
import io
import json
import re
from pathlib import Path

import pytest

from repro.check import CheckConfig as RefConfig
from repro.check import check_source as ref_check_source
from repro.check.engine import Finding as RefFinding
from repro.check.reporters import report_json as ref_report_json
from repro.check.reporters import report_text as ref_report_text
from repro.check.rules import default_rules as ref_default_rules
from repro_torch.check import CheckConfig, check_paths, check_source
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.reporters import report_json, report_text
from repro_torch.check.rules import NOT_PORTED, default_rules

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = ROOT / "tests" / "fixtures" / "check"
_EXPECT = re.compile(r"#\s*expect:\s*(?P<rules>[\w\-]+(?:\s*,\s*[\w\-]+)*)")

# fixtures are seeded violations: lint them with the path exclude lifted
FIXTURE_CFG = CheckConfig(exclude=())
REF_FIXTURE_CFG = RefConfig(exclude=())
REFERENCE_IDS = {
    "use-after-donate", "missing-alias-break", "pallas-alias",
    "kernel-gate", "host-sync", "rng-order", "global-rng",
    "jit-in-loop", "unhashable-static", "loop-varying-static",
}
MUST_PORT = {"host-sync", "rng-order", "global-rng", "missing-alias-break",
             "kernel-gate", "jit-in-loop"}
# kernel-gate holds modules under src/ outside kernels/
SRC_PATH = "src/repro_torch/core/fixture.py"

HOST_SYNC = '''\
"""Seeded host-sync violations of the port's forms."""
import numpy as np
import torch
from repro_torch.check.runtime import fetch
from repro_torch.kernels.gossip_mix.ops import gossip_mix


def _dispatch_rows(W, P):
    out = gossip_mix(W, P)
    a = out.tolist()  # expect: host-sync
    b = out.sum().numpy()  # expect: host-sync
    c = out.cpu()  # expect: host-sync
    d = complex(out[0, 0])  # expect: host-sync
    e = float(torch.linalg.norm(W))  # expect: host-sync
    big = bool((out > 0).any())  # expect: host-sync
    ok = fetch(out.max())
    f = float(ok)
    n = int(out.numel()) + int(out.shape[0]) + int(out.size(1))
    dev = int(torch.cuda.device_count())
    quiet = out.tolist()  # repro: disable=host-sync
    return a, b, c, d, e, big, f, n, dev, quiet


def record_events(rows):
    t = torch.as_tensor(rows)
    t = np.asarray(rows)
    return int(t.sum())


def drain_later(W):
    # outside the dispatch scopes: a deliberate drain-time sync
    return W.sum().item()
'''

RNG_ORDER = '''\
"""Seeded rng-order / global-rng violations of torch's generators."""
import torch


class TorchSampler:  # expect: rng-order
    def __init__(self, seed):
        self._rng = torch.Generator().manual_seed(seed)

    def draw(self):
        return torch.rand(4, generator=self._rng)


class DeclaredTorchSampler:
    rng_methods = ("draw",)

    def __init__(self, seed):
        self.rng = torch.Generator(device="cpu")
        self.rng.manual_seed(seed)
        self.base = torch.randn(8, generator=self.rng)

    def draw(self):
        return torch.rand(4, generator=self.rng)

    def debug(self):
        return torch.randn(2, generator=self.rng)  # expect: rng-order

    def peek(self):
        return self.rng.get_state()  # expect: rng-order

    def quiet(self):
        return torch.randn(2, generator=self.rng)  # repro: disable=rng-order


def global_draws(x):
    a = torch.rand(3)  # expect: global-rng
    b = torch.randint(0, 4, (3,))  # expect: global-rng
    c = torch.randn_like(x)  # expect: global-rng
    x.uniform_()  # expect: global-rng
    torch.nn.init.normal_(x)  # expect: global-rng
    d = torch.bernoulli(x)  # expect: global-rng
    e = torch.randperm(4)  # repro: disable=global-rng
    g = torch.Generator().manual_seed(0)
    ok = torch.rand(3, generator=g) + torch.randn(3, generator=g)
    x.normal_(0.0, 1.0, generator=g)
    return a, b, c, d, e, ok
'''

ALIAS_BREAK = '''\
"""Seeded missing-alias-break violations."""
from repro_torch.core.aau import sparse_event_update


class Runner:
    def __init__(self, W):
        self.W = W
        self.S = self.W  # expect: missing-alias-break
        self.S = dict(self.W)  # expect: missing-alias-break
        self.S = {k: v for k, v in self.W.items()}  # expect: missing-alias-break
        self.S = {k: v.detach() for k, v in self.W.items()}  # expect: missing-alias-break
        self.W, self.S = W, W  # expect: missing-alias-break
        self.S = {k: v.clone() for k, v in self.W.items()}
        self.S = dict(self.W)  # repro: disable=missing-alias-break
        self._pair_block = None

    def step(self, block):
        self._pair_block = block
        self._pair_block((self.W, self.S))


class NoBlock:
    def __init__(self, W):
        self.S = self.W = W


def feed(W, pools, grad_fn, workers, P):
    S = W.copy()  # expect: missing-alias-break
    W, S2 = W, {k: v.clone() for k, v in W.items()}
    return sparse_event_update(W, S, S2, pools, grad_fn, workers, P)


def not_a_block_scope(W):
    S = W
    return S
'''

KERNEL_GATE = '''\
"""Seeded kernel-gate violations (linted as a module under src/)."""
import repro_torch.kernels.linear_scan.ref
from repro_torch import kernels
from repro_torch.kernels.gossip_mix import ops as gossip_ops
from repro_torch.kernels.gossip_mix.ops import gossip_mix
from repro_torch.kernels.gossip_mix.ops import gossip_mix_plain as mix
from repro_torch.kernels.sparse_gossip.ref import sparse_gossip_ref
from repro_torch.models.layers import _plain_attention


def update(W, P, a, x, q):
    y = gossip_mix(W, P)
    y = mix(W, P)  # expect: kernel-gate
    y = gossip_ops.masked_gossip_plain(W, P, P, P)  # expect: kernel-gate
    y = sparse_gossip_ref(W, P, P)  # expect: kernel-gate
    z = repro_torch.kernels.linear_scan.ref.linear_scan_ref(a, x)  # expect: kernel-gate
    z = kernels.sparse_gossip.ops.scatter_rows_plain(x, a, a)  # expect: kernel-gate
    z = gossip_ops.gossip_mix_batched(W, P)
    o = _plain_attention(q, q, q, None, None, 8)
    y = gossip_ops.gossip_mix_plain(W, P)  # repro: disable=kernel-gate
    return y, z, o
'''

JIT_IN_LOOP = '''\
"""Seeded jit-in-loop violations."""
import torch

from repro_torch.kernels import build


def drive(blocks, fn, xs):
    for b in blocks:
        step = torch.compile(fn)  # expect: jit-in-loop
        s = torch.jit.script(fn)  # expect: jit-in-loop
        g = torch.cuda.CUDAGraph()  # expect: jit-in-loop
        with torch.cuda.graph(g):  # expect: jit-in-loop
            step(b)
        build.build(("masked_gossip",))  # expect: jit-in-loop
        build.load("gossip_mix")  # repro: disable=jit-in-loop
    while xs:
        t = torch.jit.trace(fn, xs.pop())  # expect: jit-in-loop
    compiled = torch.compile(fn)
    build.build()
    for b in blocks:
        compiled(b)

        def inner():
            return torch.compile(fn)
    return compiled, s, t, inner
'''

FIXTURES = {"host_sync": HOST_SYNC, "rng_order": RNG_ORDER,
            "alias_break": ALIAS_BREAK, "kernel_gate": KERNEL_GATE,
            "jit_in_loop": JIT_IN_LOOP}


def _expectations(source):
    exp = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        m = _EXPECT.search(line)
        if m:
            exp[lineno] = {r.strip() for r in m.group("rules").split(",")}
    return exp


def _by_line(findings):
    got = {}
    for f in findings:
        got.setdefault(f.line, set()).add(f.rule)
    return got


def _located(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


# -- each ported rule: seeded violations, pragma-suppressed twins -------------

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_match_expectations(name):
    source = FIXTURES[name]
    expected = _expectations(source)
    assert expected, f"fixture {name} declares no expectations"
    assert "repro: disable" in source, f"fixture {name} has no suppressed twin"
    findings = check_source(source, SRC_PATH, FIXTURE_CFG)
    assert _by_line(findings) == expected
    # the twins are findings once their pragma is gone
    bare = re.sub(r"\s*# repro: disable=[\w\-]+", "", source)
    assert len(check_source(bare, SRC_PATH, FIXTURE_CFG)) > len(findings)


def test_every_ported_rule_has_a_fixture():
    seen = set()
    for source in FIXTURES.values():
        for rules in _expectations(source).values():
            seen |= rules
    ported = {i for r in default_rules() for i in r.ids()}
    assert ported == seen


@pytest.mark.parametrize("path", ["tests/test_fixture.py", "chip_smoke.py",
                                  "src/repro_torch/kernels/gossip_mix/ops.py"])
def test_kernel_gate_holds_only_modules_under_src_outside_kernels(path):
    findings = check_source(KERNEL_GATE, path, FIXTURE_CFG)
    assert findings == []


# -- rule coverage ------------------------------------------------------------

def test_every_reference_rule_is_ported_or_listed_with_a_reason():
    ref_ids = {i for r in ref_default_rules() for i in r.ids()}
    assert ref_ids == REFERENCE_IDS
    ported = {i for r in default_rules() for i in r.ids()}
    assert MUST_PORT <= ported
    assert not ported & set(NOT_PORTED)
    assert ported | set(NOT_PORTED) == REFERENCE_IDS
    for rule_id, reason in NOT_PORTED.items():
        assert isinstance(reason, str) and len(reason.strip()) > 20, rule_id


# -- parity with the reference ------------------------------------------------

def test_numpy_rules_match_the_reference_on_its_fixture():
    fixture = REF_FIXTURES / "rng_order_violations.py"
    source = fixture.read_text()
    ref = ref_check_source(source, str(fixture), REF_FIXTURE_CFG)
    port = check_source(source, str(fixture), FIXTURE_CFG)
    assert ref and _located(port) == _located(ref)
    assert [f.message for f in port] == [f.message for f in ref]


def _torch_host_sync_fixture(source):
    """The reference's host-sync fixture in torch, line for line."""
    out = source.replace("import jax\nimport jax.numpy as jnp\n",
                         "import torch\n"
                         "from repro_torch.check.runtime import fetch\n")
    out = out.replace("jax.device_get", "fetch").replace("jnp.", "torch.")
    assert "jax" not in out and "jnp" not in out
    assert len(out.splitlines()) == len(source.splitlines())
    return out


def test_host_sync_flags_the_references_lines_in_torch():
    fixture = REF_FIXTURES / "host_sync_violations.py"
    source = fixture.read_text()
    ref = ref_check_source(source, str(fixture), REF_FIXTURE_CFG)
    port = check_source(_torch_host_sync_fixture(source), "t.py", FIXTURE_CFG)
    assert ref and _located(port) == _located(ref)
    # the JAX original holds no tensor: the port's rule sees nothing there
    assert check_source(source, str(fixture), FIXTURE_CFG) == []


@pytest.mark.parametrize("source", [
    "import numpy as np\nx = np.random.rand(3)  # repro: disable\n",
    "import numpy as np\nx = np.random.rand(3)  # repro: disable=host-sync\n",
    "import numpy as np\nx = np.random.rand(3)  # repro: disable=global-rng\n",
    'import numpy as np\ns = "# repro: disable=global-rng"\nx = np.random.rand(3)\n',
    "def broken(:\n",
    "x = (\n",
], ids=["blanket", "other-rule", "named", "in-string", "parse-error",
        "unterminated"])
def test_pragmas_and_parse_errors_as_the_reference(source):
    ref = ref_check_source(source, "t.py", REF_FIXTURE_CFG)
    port = check_source(source, "t.py", FIXTURE_CFG)
    assert _located(port) == _located(ref)
    assert [f.message for f in port] == [f.message for f in ref]


@pytest.mark.parametrize("enabled,rules", [
    (("global-rng",), set()),
    (("rng-order",), {"rng-order", "global-rng"}),
    (("host-sync",), set()),
    ((), {"rng-order", "global-rng"}),
])
def test_rule_selection_as_the_reference(enabled, rules):
    fixture = REF_FIXTURES / "rng_order_violations.py"
    source = fixture.read_text()
    port = check_source(source, str(fixture),
                        CheckConfig(exclude=(), enabled_rules=enabled))
    ref = ref_check_source(source, str(fixture),
                           RefConfig(exclude=(), enabled_rules=enabled))
    assert {f.rule for f in port} == rules
    assert _located(port) == _located(ref)


def test_default_config_excludes_fixture_corpus():
    assert check_paths([str(REF_FIXTURES)]) == []
    assert check_paths([str(REF_FIXTURES)], FIXTURE_CFG), (
        "lifting the exclude must surface the seeded violations")


@pytest.mark.parametrize("fixture", ["host_sync", "rng_order", "empty"])
@pytest.mark.parametrize("fmt", ["text", "json"])
def test_reports_are_byte_identical_to_the_references(fixture, fmt):
    source = FIXTURES.get(fixture, "")
    findings = check_source(source, SRC_PATH, FIXTURE_CFG)
    assert bool(findings) == (fixture != "empty")
    ref_findings = [RefFinding(**f.to_json()) for f in findings]
    port_out, ref_out = io.StringIO(), io.StringIO()
    (report_text if fmt == "text" else report_json)(findings, port_out)
    (ref_report_text if fmt == "text" else ref_report_json)(ref_findings, ref_out)
    assert port_out.getvalue() == ref_out.getvalue()


def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("import torch\n\n\ndef f(g):\n"
                     "    return torch.rand(3, generator=g)\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text(JIT_IN_LOOP)
    assert check_main([str(clean)]) == 0
    assert capsys.readouterr().out == "clean: no findings\n"
    assert check_main(["--format", "json", str(dirty), str(clean)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"] == {"jit-in-loop": 6} and doc["total"] == 6
    assert {f["path"] for f in doc["findings"]} == {str(dirty)}
    assert check_main(["--rules", "host-sync", str(dirty)]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        check_main(["--format", "xml", str(clean)])
    assert exc.value.code == 2
    capsys.readouterr()


def test_cli_include_fixtures(capsys):
    fixture = str(REF_FIXTURES / "rng_order_violations.py")
    assert check_main([fixture]) == 0
    assert check_main(["--include-fixtures", fixture]) == 1
    assert "[global-rng]" in capsys.readouterr().out


# -- the port's own contracts, broken in memory ---------------------------------

def test_alias_break_guards_the_runner():
    """Dropping the runner's ``.clone()`` of W into S is a finding."""
    path = ROOT / "src" / "repro_torch" / "core" / "runner.py"
    source = path.read_text()
    line = "        self.S = {k: v.clone() for k, v in self.W.items()}\n"
    assert source.count(line) == 1
    broken = source.replace(line, line.replace("v.clone()", "v"))
    at = source[:source.index(line)].count("\n") + 1
    findings = check_source(broken, "src/repro_torch/core/runner.py")
    assert [(f.rule, f.line) for f in findings] == [("missing-alias-break", at)]


def test_kernel_gate_guards_the_active_set_update():
    """Calling ``scatter_rows_plain`` where aau.py calls the wrapper is a
    finding."""
    path = ROOT / "src" / "repro_torch" / "core" / "aau.py"
    source = path.read_text()
    call = "scatter_active_rows(w, Wn[k], workers)"
    assert source.count(call) == 1
    broken = source.replace(call, call.replace("scatter_active_rows",
                                               "scatter_rows_plain"))
    broken = broken.replace("scatter_active_rows)",
                            "scatter_active_rows, scatter_rows_plain)", 1)
    at = source[:source.index(call)].count("\n") + 1
    findings = check_source(broken, "src/repro_torch/core/aau.py")
    assert [(f.rule, f.line) for f in findings] == [("kernel-gate", at)]


# -- the gate -------------------------------------------------------------------

def test_repo_tree_is_clean():
    """Zero findings on src/tests/benchmarks and chip_smoke.py."""
    findings = check_paths([str(ROOT / "src"), str(ROOT / "tests"),
                            str(ROOT / "benchmarks"),
                            str(ROOT / "chip_smoke.py")])
    assert findings == [], "\n".join(f.format() for f in findings)
