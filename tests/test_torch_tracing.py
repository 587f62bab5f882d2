"""The port's tracer (``repro_torch.tracing``) on the CPU, and under capture on the card.

Spans record only while ``torch.profiler`` records; off, a span is one flag
read and a shared null context. The card test is marked ``cuda`` and skips
here.
"""

import threading
import time

import pytest
import torch

from repro_torch import tracing
from repro_torch.api.session import Session
from repro_torch.core import baselines, objectives
from repro_torch.core.simulate import ClusterModel


def _profiled(fn):
    """Run ``fn`` under a CPU profiler; returns the profiler, stopped."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    return prof


def _records():
    return list(tracing._window.records)


def _enter_exit(name):
    with tracing.span(name):
        pass


@pytest.fixture(autouse=True)
def window_closed():
    """A span seen with the profiler off ends the last traced window, as the
    untraced work between two traced windows does in a program."""
    _enter_exit("off")


def test_the_profiler_flag_the_fast_path_reads():
    # The flag and the fast range are private to torch: pin that the flag
    # exists and follows a session (the range: the profiler's events below).
    assert torch.autograd.profiler._is_profiler_enabled is False
    seen = []
    _profiled(lambda: seen.append(torch.autograd.profiler._is_profiler_enabled))
    assert seen == [True] and torch.autograd.profiler._is_profiler_enabled is False


def test_off_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    a, b = tracing.span("x"), tracing.span("y")
    assert a is tracing._NULL and b is tracing._NULL
    with a, tracing.span("nested"):
        pass


def test_nested_spans_record_parents_a_root_counts_and_self_time():
    def work():
        with tracing.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with tracing.span("inner"):
                    time.sleep(0.003)
                    with tracing.span("sync.wait", syncs=2):
                        time.sleep(0.001)

    prof = _profiled(work)
    recs = _records()
    outer = [r for r in recs if r.name == "outer"]
    inner = [r for r in recs if r.name == "inner"]
    waits = [r for r in recs if r.name == "sync.wait"]
    assert len(outer) == 1 and len(inner) == 2 and len(waits) == 2
    assert outer[0].parent is None and outer[0].root == outer[0].id
    assert all(r.parent is outer[0] and r.root == outer[0].id for r in inner)
    assert [r.parent for r in waits] == inner and {r.root for r in waits} == {outer[0].id}
    assert all(r.ev0 is None for r in recs)  # no events off the card
    s = tracing.summary()
    assert s["dropped"] == 0
    assert s["spans"]["inner"]["count"] == 2 and s["spans"]["outer"]["count"] == 1
    o, i, w = s["spans"]["outer"], s["spans"]["inner"], s["spans"]["sync.wait"]
    assert w["count"] == 2 and w["syncs"] == 4 and "syncs" not in i
    assert o["self_host_ms"] == pytest.approx(o["host_ms"] - i["host_ms"])
    assert i["self_host_ms"] == pytest.approx(i["host_ms"] - w["host_ms"])
    assert i["wait_ms"] == pytest.approx(w["host_ms"]) and w["host_ms"] >= 2.0
    assert o["wait_ms"] == pytest.approx(w["host_ms"])  # at any depth
    assert i["self_host_ms"] >= 6.0 and o["self_host_ms"] >= 2.0
    assert o["device_ms"] is None and i["device_ms"] is None
    names = {e.name for e in prof.events()}
    assert {"repro_torch.outer", "repro_torch.inner", "repro_torch.sync.wait"} <= names


def test_a_later_profiler_session_starts_a_new_store():
    _profiled(lambda: _enter_exit("first"))
    _enter_exit("between")  # seen with the profiler off: the window has ended
    assert set(tracing.summary()["spans"]) == {"first"}
    _profiled(lambda: _enter_exit("second"))
    assert set(tracing.summary()["spans"]) == {"second"}


def test_spans_of_two_threads_do_not_nest():
    opened, done = threading.Event(), threading.Event()

    def a():
        with tracing.span("a"):
            opened.set()
            done.wait(10)

    def b():
        opened.wait(10)
        with tracing.span("b"):
            pass
        done.set()

    def work():
        ta, tb = threading.Thread(target=a), threading.Thread(target=b)
        ta.start(), tb.start()
        ta.join(10), tb.join(10)
        assert not ta.is_alive() and not tb.is_alive()

    _profiled(work)
    recs = {r.name: r for r in _records()}
    assert recs["a"].parent is None and recs["b"].parent is None
    assert recs["b"].root == recs["b"].id != recs["a"].id


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)

    def work():
        for _ in range(5):
            _enter_exit("s")

    _profiled(work)
    s = tracing.summary()
    assert s["spans"]["s"]["count"] == 3 and s["dropped"] == 2


def test_a_session_records_its_layers_and_no_span_outlives_a_yield():
    X = torch.randn(4, 16, 64) / 8
    y = torch.sign(torch.randn(4, 16))
    problem = objectives.Problem(X=X, y=y, lam=1e-3, loss="ridge")
    method = baselines.acpd(4, 64, B=2, T=3, rho_d=8, gamma=0.5, H=10)
    open_at_yield = []

    def work():
        s = Session(problem, method, ClusterModel(4), num_outer=1, seed=3, device="cpu")
        for _ in s.events():
            open_at_yield.append(len(tracing._local.spans))

    _profiled(work)
    assert open_at_yield and set(open_at_yield) == {0}
    s = tracing.summary()["spans"]
    assert s["session.setup"]["count"] == 1 and s["solver.norms_sq"]["count"] == 1
    assert s["engine.round"]["count"] == 3 and s["engine.eval"]["count"] == 1
    # The first launch's index copy, then three a round (the relaunch's, the
    # server's, the reply's); a round's reply bytes and applied mask; the
    # four certificate vectors; w, alpha and the applied alpha.
    assert s["sync.index"]["count"] == 1 + 3 * 3
    assert s["sync.reply_nnz"]["count"] == s["sync.applied_mask"]["count"] == 3
    assert s["sync.certificates"]["count"] == 4 and s["sync.result"]["count"] == 3


@pytest.mark.cuda
def test_a_span_under_capture_records_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1024, device="cuda")
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())

    def work():
        with torch.cuda.stream(stream):
            x.add_(1)  # warm up on the side stream before capture
        torch.cuda.current_stream().wait_stream(stream)
        with tracing.span("outside"):
            with torch.cuda.graph(g):
                inside = tracing.span("inside", timed=True)
                assert inside is tracing._NULL
                with inside:
                    x.mul_(2)
        with tracing.span("replay", timed=True):
            g.replay()
        torch.cuda.synchronize()

    _profiled(work)
    assert [r.name for r in _records()] == ["outside", "replay"]
    spans = tracing.summary()["spans"]
    assert spans["outside"]["device_ms"] is None and spans["replay"]["device_ms"] > 0
    assert torch.equal(x, torch.full_like(x, 4.0))  # (1 + 1), then x 2 by the replay alone
