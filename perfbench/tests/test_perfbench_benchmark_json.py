"""BENCHMARK.json's form (names, units, keys, limits of size), and every file it leads to."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_bench()


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_full_check_fits_its_time(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and (harness.ROOT / c["file"]).is_file()
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not (key.endswith("_dim") or key.endswith("_rank") or "size" in key
                        or "heads" in key or "expert" in key)


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
        traffic = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    # Each per-layer metric moves an end-to-end metric that all its cells report.
    by_name = {m["name"]: m for m in e2e}
    for m in layer:
        assert m["moves"] in by_name
        moved_in = set(by_name[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", moved_in)) <= moved_in


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_layers_keep_one_name(bench):
    roofline = [m for m in bench["per_layer"] if m["name"].endswith("roofline") or "mfu" in m["name"]]
    assert all(m["unit"] == "%" for m in roofline)
    assert any("mfu" in m["name"] for m in bench["per_layer"])
