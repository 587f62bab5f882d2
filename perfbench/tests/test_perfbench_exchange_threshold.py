"""exchange_threshold.roofline: its counted bytes against a hand count, and its reading."""

from __future__ import annotations

import importlib.util
import json
import math

import pytest

from perfbench import harness
from perfbench.inputs import weights

CONFIG = json.loads((harness.HERE / "configs" / "phi3-medium-14b.json").read_text())
EXCHANGE = json.loads((harness.HERE / "traffic" / "acpd-exchange.json").read_text())["exchange"]


def metric():
    spec = importlib.util.spec_from_file_location(
        "m_exchange_threshold_roofline",
        harness.HERE / "metrics" / "exchange_threshold.roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_leaves_by_hand():
    # embedding and head 32,064 x 5,120 each; per layer q and o 5,120 x 5,120, k and v
    # 5,120 x 1,280, gate, up and down 5,120 x 17,920, two norms of 5,120; 2 layers
    # stacked; the final norm 5,120. Twelve leaves, all at least 1,024.
    layer = 2 * 26_214_400 + 2 * 6_553_600 + 3 * 91_750_400 + 2 * 5_120
    sizes = [math.prod(shape) for shape, _ in weights.shapes(CONFIG).values()]
    assert len(sizes) == 12 and min(sizes) == 5_120 and max(sizes) == 183_500_800
    assert sum(sizes) == 2 * 164_167_680 + 2 * layer + 5_120 == 1_009_935_360
    assert metric().filtered_coordinates(CONFIG, EXCHANGE) == 1_009_935_360
    assert metric().filtered_coordinates(CONFIG, dict(EXCHANGE, min_leaf_size=6_000)) == (
        1_009_935_360 - 5_120)


def test_bytes_of_one_needed_group_and_step():
    m = metric()
    assert m.group_step_bytes(CONFIG, EXCHANGE) == 4 * 3 * 1_009_935_360
    assert m.group_step_bytes(CONFIG, dict(EXCHANGE, refine=False)) == 4 * 2 * 1_009_935_360
    # B = 2 groups on 9 sparse steps of every 10.
    assert m.needed_groups_per_step(EXCHANGE) == pytest.approx(1.8)


@pytest.mark.parametrize("units, seconds", [(10, 0.25), (20, 0.3)])
def test_reading_on_a_made_up_trace(units, seconds):
    kernels = [("void (anonymous namespace)::exchange_threshold_round<1>(float const*)", 0,
                int(seconds * 0.6e9)),
               ("(anonymous namespace)::exchange_threshold_max(float const*)", 0,
                int(seconds * 0.4e9)),
               ("kernelHistogram1D", 0, 10_000_000)]
    ctx = harness.TraceContext(config=CONFIG, traffic={"exchange": EXCHANGE},
                               peaks=harness.peaks(), units=units, window_s=10.0, busy_s=9.0,
                               kernels=kernels, spans={})
    want = 100 * units * 1.8 * 12 * 1_009_935_360 / 3.35e12 / seconds
    assert harness.load_reader("exchange_threshold.roofline")(ctx) == pytest.approx(want)


@pytest.mark.parametrize("kernels, traffic, units", [
    ([("kernelHistogram1D", 0, 5_000_000)], {"exchange": EXCHANGE}, 10),  # the parent's path
    ([], {"exchange": EXCHANGE}, 10),
    ([("exchange_threshold_max", 0, 5_000_000)], {}, 10),  # no exchange in the traffic
    ([("exchange_threshold_max", 0, 5_000_000)], {"exchange": EXCHANGE}, 0),
])
def test_reads_none_without_the_kernel_or_the_work(kernels, traffic, units):
    ctx = harness.TraceContext(config=CONFIG, traffic=traffic, peaks=harness.peaks(),
                               units=units, window_s=10.0, busy_s=9.0, kernels=kernels, spans={})
    assert harness.load_reader("exchange_threshold.roofline")(ctx) is None
