"""No module of the benchmark imports JAX, Flax or the JAX package, and
the reference imports nothing of the program. Top-level names are
compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported_tops(path)


def test_the_runtime_guard_compares_whole_names(monkeypatch):
    import sys

    import portbench.run as run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]
