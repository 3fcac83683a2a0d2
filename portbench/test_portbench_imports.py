"""Nothing under portbench imports JAX, its libraries or the JAX package
(top-level names compared whole), and the reference imports nothing of the
program."""
import ast
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.relative_to(HERE).parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core.aau",
                              "jaxtyping", "reprolib", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["flax", "jax", "jaxlib", "repro"]
