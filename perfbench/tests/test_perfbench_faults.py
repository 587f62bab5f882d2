"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
(set-up, window, check) at a tiny size on the CPU, with one fault planted
in the program: a step that leaves its state unchanged, half of the batch
left out (the workers of a round, or the rows of a batch, the mean taken
over the rest), an answer altered where it is produced (a certificate, or
a leaf's gradient), and in the
exchanging cell the exchange left out or its dense sync skipped. The cells take one card, so there is
no exchange between cards to leave out. The controls (the reference one
precision lower in the program's place) must come out not correct as well.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests.conftest import tiny_cell

SEED = 2**31 + 9_000_011
SOLVER_CELLS = ["rcv1-k8.acpd", "rcv1-k8.cocoa-plus"]
TRAIN_CELLS = ["phi3-medium-14b.acpd-exchange", "phi3-medium-14b.plain"]


@contextlib.contextmanager
def solver_fault(fault: str):
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    orig_epoch, orig_eval = ops.sdca_epoch, engine._eval_batched
    if fault == "state_unchanged":
        def sdca_epoch(w_eff, alpha, *a, **kw):
            dalpha, v = orig_epoch(w_eff, alpha, *a, **kw)
            return torch.zeros_like(dalpha), torch.zeros_like(v)
        patch(ops, "sdca_epoch", sdca_epoch)
    elif fault == "half_batch":
        def sdca_epoch(w_eff, alpha, *a, **kw):
            dalpha, v = orig_epoch(w_eff, alpha, *a, **kw)
            keep = (torch.arange(v.shape[0]) < max(1, v.shape[0] // 2))[:, None]
            return dalpha * keep, v * keep * (v.shape[0] / max(1, v.shape[0] // 2))
        patch(ops, "sdca_epoch", sdca_epoch)
    elif fault == "answer_altered":
        def _eval_batched(ws, alphas, problem):
            p, dv, gap, gap_srv = orig_eval(ws, alphas, problem)
            return p, dv, gap * 1.01, gap_srv
        patch(engine, "_eval_batched", _eval_batched)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", SOLVER_CELLS)
def test_solver_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with solver_fault(fault):
        out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is False, out["checks"]


@contextlib.contextmanager
def gradient_altered():
    """One leaf's gradient 5 % too large where ``value_and_grad`` makes it."""
    from repro_torch.launch import steps

    orig = steps.value_and_grad

    def value_and_grad(loss_fn, params, batch):
        loss, grads = orig(loss_fn, params, batch)
        grads["final_norm"]["scale"] = grads["final_norm"]["scale"] * 1.05
        return loss, grads
    steps.value_and_grad = value_and_grad
    try:
        yield
    finally:
        steps.value_and_grad = orig


@contextlib.contextmanager
def dense_sync_skipped():
    """The exchange's every T-th step sends sparsely like the others."""
    import dataclasses

    from repro_torch.core import exchange

    orig = exchange._round_masks

    def _round_masks(cfg, step):
        return orig(dataclasses.replace(cfg, sync_period=2**30), step)
    exchange._round_masks = _round_masks
    try:
        yield
    finally:
        exchange._round_masks = orig


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "exchange_left_out",
                                   "answer_altered", "dense_sync_skipped"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    exchanging = cell.traffic.get("exchange") is not None
    if fault in ("exchange_left_out", "dense_sync_skipped") and not exchanging:
        pytest.skip("the plain step has no exchange to break")
    ctx = {"answer_altered": gradient_altered,
           "dense_sync_skipped": dense_sync_skipped}.get(fault)
    ctx = ctx() if ctx else calibrate.planted(fault, exchanging)
    with ctx:
        out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", SOLVER_CELLS)
def test_solver_control_is_not_correct(name):
    """TF32 products in the reference, put in the program's place."""
    from perfbench.drivers import solver_runs
    from perfbench.inputs import rcv1
    from perfbench.reference import solver as reference

    cell = tiny_cell(name)
    X, y = rcv1.make(cell.config, SEED, torch.device("cpu"))
    got = reference.run(X, y, cell.config, cell.traffic, SEED, precision="tf32")
    want = reference.run(X, y, cell.config, cell.traffic, SEED)
    numbers = solver_runs.compare(got, want)
    limits = cell.limits["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_control_is_not_correct(name):
    """Float8 products in the reference, put in the program's place."""
    from perfbench.drivers import train_steps
    from perfbench.reference import decoder as reference

    cell = tiny_cell(name)
    ws, ts = harness.derive_seed(SEED, 10), harness.derive_seed(SEED, 11)
    ctrl = reference.train(cell.config, cell.traffic, ws, ts, "cpu", precision="fp8",
                           keep_values=True)
    want = reference.train(cell.config, cell.traffic, ws, ts, "cpu", judges=[ctrl["values"]])
    got = {"loss": ctrl["loss"], "bytes": ctrl["bytes"]}
    for k in ("grad", "change", "residual"):
        if ctrl[k] is not None:
            got[k] = dict(zip(ctrl["paths"], ctrl[k]))
    numbers = train_steps.compare(got, want, want["grad_dist"][0])
    limits = cell.limits["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers
