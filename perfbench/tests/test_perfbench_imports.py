"""What the benchmark's files may import and read.

No module under ``perfbench/`` imports JAX or the JAX package (names are
compared whole at the top level, so ``repro_torch`` is not ``repro``); the
references import nothing of the program; nothing reads ``benchmarks/``.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

from perfbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = [p for p in FILES if p.parent.name == "reference"]


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_nor_the_jax_package(path):
    found = top_level_imports(path) & set(harness.FORBIDDEN_MODULES)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    # ... nor anything of the benchmark that does.
    for mod in top_level_imports(path):
        assert mod in ("torch", "math", "heapq", "contextlib", "statistics", "__future__",
                       "perfbench"), mod
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("perfbench"):
            assert node.module.split(".")[1] in ("inputs", "reference"), node.module


def test_reference_inputs_import_nothing_of_the_program():
    for path in sorted((harness.HERE / "inputs").glob("*.py")):
        assert "repro_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in FILES if p.resolve() != pathlib.Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_nothing_reads_the_old_benchmarks(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "import benchmarks" not in text
    assert "benchmarks" not in top_level_imports(path)


def test_forbidden_names_are_compared_whole():
    import sys

    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        assert "repro_torch_lookalike_for_test" not in harness.forbidden_loaded()
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)
