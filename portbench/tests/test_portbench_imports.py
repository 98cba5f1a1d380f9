"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either. Top-level names are
compared whole: the program's package name begins with the JAX package's."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN, f"{path} imports {imported(path) & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_the_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import repro.core\nfrom jax import numpy\nimport repro_torch\n")
    assert imported(bad) & FORBIDDEN == {"repro", "jax"}
