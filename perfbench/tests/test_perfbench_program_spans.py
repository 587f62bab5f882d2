"""The readers of the program's own spans and counters (``repro_torch.tracing``)."""

from __future__ import annotations

import math
import sys

import pytest

from perfbench import harness
from perfbench.inputs import weights
from perfbench.tests.conftest import tiny_cell

SEED = 2**31 + 4_000_041
DEVICE_MS = ("solver.norms_sq.ms_per_run", "eval.ms_per_run", "exchange.threshold_ms_per_step",
             "optimizer.ms_per_step")
MADE_UP = {
    "spans": {"solver.norms_sq": {"count": 2, "host_ms": 1.0, "self_host_ms": 1.0,
                                  "device_ms": 60.0},
              "engine.eval": {"count": 2, "host_ms": 9.0, "self_host_ms": 2.0, "device_ms": 80.0},
              "engine.round": {"count": 40, "host_ms": 50.0, "self_host_ms": 30.0,
                               "wait_ms": 20.0, "device_ms": 300.0},
              "sync.index": {"count": 10, "host_ms": 4.0, "self_host_ms": 4.0, "device_ms": None,
                             "syncs": 10},
              "sync.bincount": {"count": 2, "host_ms": 16.0, "self_host_ms": 16.0,
                                "device_ms": None, "syncs": 4},
              "exchange.threshold": {"count": 96, "host_ms": 20.0, "self_host_ms": 4.0,
                                     "device_ms": 1400.0},
              "optimizer.update": {"count": 2, "host_ms": 3.0, "self_host_ms": 3.0,
                                   "device_ms": 150.0}},
    "dropped": 0,
    "launches": {"sdca_inner": 42, "topk_filter": 5, "flash_attention_fwd": 0},
    "executor": {"lockstep_calls": 9, "lockstep_traces": 2, "lag_traces": 1},
}

READERS = [(m["name"], m) for m in harness.load_bench()["per_layer"]
           if m["name"] in ("solver.norms_sq.ms_per_run", "eval.ms_per_run",
                            "engine.host_ms_per_run", "solver.syncs_per_run",
                            "sdca_inner.launches_per_run", "executor.captures_per_run",
                            "exchange.threshold_ms_per_step", "exchange.syncs_per_step",
                            "optimizer.ms_per_step")]


def _ctx(units: int):
    return harness.TraceContext(config={}, traffic={}, peaks=harness.peaks(), units=units,
                                window_s=1.0, busy_s=0.5, kernels=[], spans={})


@pytest.mark.parametrize("name, want", [
    ("solver.norms_sq.ms_per_run", 30.0), ("eval.ms_per_run", 40.0),
    ("engine.host_ms_per_run", 15.0), ("solver.syncs_per_run", 7.0),
    ("sdca_inner.launches_per_run", 21.0), ("executor.captures_per_run", 1.5),
    ("exchange.threshold_ms_per_step", 700.0), ("exchange.syncs_per_step", 7.0),
    ("optimizer.ms_per_step", 75.0),
])
def test_readers_on_a_made_up_summary(monkeypatch, name, want):
    from repro_torch import tracing

    monkeypatch.setattr(tracing, "summary", lambda: MADE_UP)
    assert harness.load_reader(name)(_ctx(2)) == pytest.approx(want)
    assert harness.load_reader(name)(_ctx(0)) is None


@pytest.mark.parametrize("name", DEVICE_MS)
def test_device_readers_read_nothing_without_device_time(monkeypatch, name):
    from repro_torch import tracing

    off_card = {**MADE_UP, "spans": {k: dict(v, device_ms=None)
                                     for k, v in MADE_UP["spans"].items()}}
    monkeypatch.setattr(tracing, "summary", lambda: off_card)
    assert harness.load_reader(name)(_ctx(2)) is None


def test_readers_read_nothing_from_a_program_without_the_tracer(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # import raises
    for name, _ in READERS:
        assert harness.load_reader(name)(_ctx(2)) is None


def test_the_nine_entries_are_there():
    assert len(READERS) == 9


def _solver_syncs(cell) -> int:
    """The ``sync.*`` spans of one tiny run on the CPU. ACPD (the event
    engine, R rounds): sigma' to the device; the first launch's index copy
    and three a round (the relaunch's, the server's, the reply's), a round's
    reply bytes and applied mask; CoCoA+ (the executor, which copies no
    index): sigma' only. Then both: the four certificate vectors read and
    the result's w and alpha, and ACPD's applied alpha. The card adds the
    kernel's worker map, one a launch (1 + R), which the CPU's plain version
    does not copy."""
    t = cell.traffic
    if t["method"]["protocol"] == "group":
        rounds = t["num_outer"] * t["method"]["T"]
        return 1 + (1 + 3 * rounds) + 2 * rounds + 4 + 3
    return 1 + 4 + 2


def _exchange_syncs(cell) -> int:
    """The syncs of one step: each histogram round (two, refined) of each
    leaf the filter takes (at least ``min_leaf_size`` coordinates), for each
    group, runs ``torch.bincount`` (two syncs) and copies one constant to the
    device; each attention layer copies its scale to the device in the
    monitored forward, in each group's forward and, under remat, again in
    its recompute."""
    e, layers = cell.traffic["exchange"], cell.config["num_hidden_layers"]
    leaves = sum(math.prod(shape) >= e["min_leaf_size"]
                 for shape, _ in weights.shapes(cell.config).values())
    rounds = 2 if e["refine"] else 1
    forwards = 1 + e["num_groups"] * (2 if cell.traffic["remat"] else 1)
    return rounds * 3 * e["num_groups"] * leaves + layers * forwards


@pytest.mark.parametrize("name", ["rcv1-k8.acpd", "rcv1-k8.cocoa-plus",
                                  "phi3-medium-14b.acpd-exchange"])
def test_a_traced_cpu_run_reads_the_counts_its_runs_make(name):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, True, "cpu")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert not set(got) & set(DEVICE_MS)  # no device time on the CPU
    if cell.traffic["driver"] == "solver_runs":
        assert got["solver.syncs_per_run"] == _solver_syncs(cell)
        assert got["sdca_inner.launches_per_run"] == 0.0  # LAUNCHES counts the card's
        if "executor.captures_per_run" in {m["name"] for m in cell.per_layer}:
            assert got["executor.captures_per_run"] == 0.0  # captured in warm-up
    else:
        assert got["exchange.syncs_per_step"] == _exchange_syncs(cell)
