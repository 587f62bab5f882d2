"""The port stands alone: nothing in ``src/repro_torch``, ``chip_smoke.py`` or
the port's profile scripts imports JAX or the JAX package ``repro``,
statically or at run time; and a test worker keeps the intra-op thread budget
that the root ``conftest.py`` gives it."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_acpd.py",
    ROOT / "scripts" / "profile_torch_serve.py", ROOT / "scripts" / "profile_torch_train.py",
    ROOT / "scripts" / "flash_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_and_no_repro(path):
    bad = sorted(m for m in _imported_modules(path)
                 if m.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_no_jax_module():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_xdist_worker_keeps_its_thread_budget():
    """Under ``-n N`` each worker has at most its share of the cores; a test
    file that raises the count and does not restore it fails here."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        pytest.skip("not an xdist worker: the thread count is PyTorch's default")
    import torch

    assert torch.get_num_threads() <= max(1, (os.cpu_count() or 1) // int(workers))
