"""Nothing in ``sortbench/`` imports JAX or the JAX package, compared by whole
top-level names (``repro_torch`` begins with ``repro``), and the plain
references import nothing of the program."""

from __future__ import annotations

import ast

import pytest

from sortbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in (ROOT / "sortbench").rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_references_import_nothing_of_the_program():
    refs = sorted((ROOT / "sortbench" / "reference").glob("*.py"))
    assert refs
    allowed = {"__future__", "numpy", "torch", "sortbench"}
    for path in refs:
        assert top_level_imports(path) <= allowed, path
    # What a reference takes from this folder is the input maker alone.
    assert top_level_imports(ROOT / "sortbench" / "generate.py") <= {"__future__", "torch"}
