"""Shared pieces of the benchmark's CPU tests: the cells cut to a tiny size."""

from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from perfbench import harness  # noqa: E402

TINY_SOLVER = {"num_features": 512, "workers": 8, "rows_per_worker": 32}
TINY_SOLVER_METHOD = {"H": 20, "rho_d": 16, "T": 5}
TINY_DECODER = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
                "num_hidden_layers": 2}
TINY_BATCH = {"batch": 8, "seq": 32}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; the test skips without one")


def tiny_cell(name: str) -> harness.Cell:
    """The cell of ``BENCHMARK.json`` with its sizes cut for the CPU; every
    other setting (method, schedule, exchange, optimizer, limits) as it is."""
    cell = harness.find_cell(harness.load_bench(), name)
    if cell.traffic["driver"] == "solver_runs":
        cell.config.update(TINY_SOLVER)
        for k, v in TINY_SOLVER_METHOD.items():
            if k in cell.traffic["method"]:
                cell.traffic["method"][k] = v
        cell.traffic["num_outer"] = min(cell.traffic["num_outer"], 3)
    else:
        cell.config.update(TINY_DECODER)
        cell.traffic.update(TINY_BATCH)
    return cell


def cell_names() -> list[str]:
    return [w["name"] for w in harness.load_bench()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads while a test of the benchmark runs: the suite's
    other workers share the machine's cores."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided when it runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
