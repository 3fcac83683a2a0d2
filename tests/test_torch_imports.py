"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports every module of ``repro_torch`` and must end
with no ``jax`` in ``sys.modules``; an AST scan of the package and of
``chip_smoke.py`` finds no import of ``jax`` or ``repro`` anywhere, inside
functions included.
"""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert "repro_torch.core.runner" in mods and "repro_torch.xp.builders" in mods
    assert "repro_torch.launch.serve" in mods
    assert "repro_torch.models.transformer" in mods
    assert "repro_torch.core.fused" in mods
    assert {"repro_torch.obs", "repro_torch.obs.metrics",
            "repro_torch.obs.trace", "repro_torch.obs.critical_path",
            "repro_torch.obs.runlog", "repro_torch.check",
            "repro_torch.check.runtime", "repro_torch.xp.__main__",
            "repro_torch.xp.sweep", "repro_torch.xp.artifacts",
            "repro_torch.xp.presets"} <= set(mods)
    assert {"repro_torch.examples.decentralized_lm", "repro_torch.data.pipeline",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.minicpm_2b",
            "repro_torch.configs.mistral_nemo_12b",
            "repro_torch.configs.deepseek_67b",
            "repro_torch.configs.paper_models"} <= set(mods)
    assert {"repro_torch.models.moe", "repro_torch.configs.grok_1_314b",
            "repro_torch.configs.arctic_480b"} <= set(mods)
    assert {"repro_torch.models.rwkv", "repro_torch.models.multimodal",
            "repro_torch.configs.rwkv6_1_6b", "repro_torch.configs.musicgen_large",
            "repro_torch.configs.llava_next_mistral_7b"} <= set(mods)
    assert {"repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedules", "repro_torch.checkpoint",
            "repro_torch.checkpoint.checkpointer", "repro_torch.launch.mesh",
            "repro_torch.launch.steps", "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.launch.sharding", "repro_torch.launch.shapes",
            "repro_torch.launch.roofline", "repro_torch.launch.dryrun"} <= set(mods)
    assert {"repro_torch.check.engine", "repro_torch.check.reporters",
            "repro_torch.check.__main__", "repro_torch.check.rules",
            "repro_torch.check.rules.host_sync",
            "repro_torch.check.rules.rng_order",
            "repro_torch.check.rules.donation",
            "repro_torch.check.rules.aliasing",
            "repro_torch.check.rules.recompile",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_batched",
            "repro_torch.examples.straggler_ablation"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}:{line} imports {root}"
           for p in files for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad
