"""Every cell's driver at a tiny size on the CPU: the result line's form and names."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import cell_names, tiny_cell

SEED = 2**31 + 4_000_037  # wider than 32 signed bits: seeds may be
KEYS = ["correct", "attempted", "failed", "metrics", "device", "units", "checks"]


@pytest.mark.parametrize("name", cell_names())
def test_untraced_line(name):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert list(out) == KEYS  # the numbers compared come last
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in cell.end_to_end}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(isinstance(v["value"], float) and v["value"] >= 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits["limits"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


@pytest.mark.parametrize("name", cell_names())
def test_traced_line(name):
    cell = tiny_cell(name)
    out = harness.run_cell(cell, SEED + 1, 0.3, True, "cpu")
    assert list(out) == KEYS[:5] + ["breakdown"] + KEYS[5:]
    # A CPU run reads no device metric: the readers find no device time.
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] == 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"] is True


def test_same_seed_same_inputs():
    import torch

    from perfbench.inputs import rcv1, tokens, weights

    cfg = tiny_cell("rcv1-k8.acpd").config
    a, b = rcv1.make(cfg, SEED, torch.device("cpu")), rcv1.make(cfg, SEED, torch.device("cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    norms = torch.linalg.vector_norm(a[0].reshape(-1, a[0].shape[-1]), dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    dec = tiny_cell("phi3-medium-14b.plain").config
    wa, wb = weights.make(dec, SEED, "cpu"), weights.make(dec, SEED, "cpu")
    assert torch.equal(wa["lm_head"]["out"], wb["lm_head"]["out"])
    s1 = tokens.TokenStream(256, 2, 8, 1.1, SEED, torch.device("cpu"))
    s2 = tokens.TokenStream(256, 2, 8, 1.1, SEED, torch.device("cpu"))
    b1, b2 = s1.next_batch(), s2.next_batch()
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(s1.next_batch()["tokens"], b1["tokens"])  # rows all differ


def test_cli_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                           "rcv1-k8.acpd", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cli_on_the_card(cuda):
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                           "rcv1-k8.cocoa-plus", "--seed", str(SEED), "--seconds", "2",
                           "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
