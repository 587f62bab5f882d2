"""Port vs JAX package: the synthetic generator, the objectives, the
problem registry and the state converter, on the CPU.

Tolerance: P, D and the gap agree to rtol 1e-5 (atol 1e-7); both packages
compute them in float32, and the sums run in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import problems as jproblems
from repro.core import objectives as jobj
from repro_torch import convert
from repro_torch.api import problems as tproblems
from repro_torch.core import acpd as tacpd
from repro_torch.core import baselines as tbaselines
from repro_torch.core import objectives as tobj
from repro_torch.core.simulate import ClusterModel

RTOL, ATOL = 1e-5, 1e-7


@pytest.mark.parametrize("kind,params", [
    ("linear_synthetic", dict(num_workers=3, n_per_worker=40, d=300, nnz_per_row=16, seed=1)),
    ("linear_synthetic", dict(num_workers=2, n_per_worker=24, d=128, task="regression", seed=4)),
    ("rcv1_like", dict(K=4, d=512, n_per_worker=32)),
])
def test_generator_is_byte_identical(kind, params):
    jp = jproblems.ProblemSpec(kind, params).build()
    tp = tproblems.ProblemSpec(kind, params).build(device="cpu")
    assert tp.X.dtype == torch.float32 and tp.y.dtype == torch.float32
    assert np.asarray(jp.X).tobytes() == tp.X.numpy().tobytes()
    assert np.asarray(jp.y).tobytes() == tp.y.numpy().tobytes()
    assert (tp.lam, tp.loss) == (jp.lam, jp.loss)
    assert tproblems.available_problems() == ("linear_synthetic", "rcv1_like")
    spec = tproblems.ProblemSpec(kind, params)
    assert tproblems.ProblemSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == jproblems.ProblemSpec(kind, params).to_dict()
    again = tproblems.build_problem(spec, device="cpu")
    assert torch.equal(again.global_X(), torch.from_numpy(np.array(jp.global_X())))
    assert torch.equal(again.global_y(), tp.y.reshape(-1))


def _dual_point(loss, y, rng):
    """A dual-feasible alpha for ``loss`` (y*alpha in (0,1) for the classifiers)."""
    u = rng.uniform(0.05, 0.95, size=y.shape).astype(np.float32)
    return (y * u).astype(np.float32) if loss != "ridge" else (u - 0.5).astype(np.float32)


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
def test_objectives_match_jax(loss):
    rng = np.random.default_rng(11)
    jp = jproblems.rcv1_like(K=3, d=256, n_per_worker=48, loss=loss)
    tp = convert.problem_from_arrays(np.asarray(jp.X), np.asarray(jp.y), jp.lam,
                                     loss, device="cpu")
    alpha = _dual_point(loss, np.asarray(jp.y), rng)
    w = (rng.standard_normal(256) * 0.1).astype(np.float32)
    ja, jw, ta, tw = jnp.asarray(alpha), jnp.asarray(w), torch.from_numpy(alpha), torch.from_numpy(w)

    pairs = [
        (jobj.primal_objective(jw, jp.X, jp.y, jp.lam, loss=loss),
         tobj.primal_objective(tw, tp.X, tp.y, tp.lam, loss=loss)),
        (jobj.dual_objective(ja, jp.X, jp.y, jp.lam, loss=loss),
         tobj.dual_objective(ta, tp.X, tp.y, tp.lam, loss=loss)),
        (jobj.duality_gap(ja, jp.X, jp.y, jp.lam, loss=loss),
         tobj.duality_gap(ta, tp.X, tp.y, tp.lam, loss=loss)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=RTOL, atol=ATOL)
    # w(alpha) entries are sums that cancel: hold them to rtol of the largest.
    jw_alpha = np.asarray(jobj.primal_from_dual(ja, jp.X, jp.lam))
    np.testing.assert_allclose(tobj.primal_from_dual(ta, tp.X, tp.lam).numpy(),
                               jw_alpha, rtol=RTOL,
                               atol=RTOL * np.abs(jw_alpha).max())
    jc = jobj.gap_certificate(jp, ja, w=jw)
    tc = tobj.gap_certificate(tp, ta, w=tw)
    assert set(jc) == set(tc)
    for key in jc:
        np.testing.assert_allclose(tc[key], jc[key], rtol=RTOL, atol=ATOL, err_msg=key)
    z = rng.standard_normal((3, 48)).astype(np.float32)
    np.testing.assert_allclose(
        tobj.dual_feasible_direction(loss, torch.from_numpy(z), tp.y).numpy(),
        np.asarray(jobj.dual_feasible_direction(loss, jnp.asarray(z), jp.y)),
        rtol=RTOL, atol=ATOL)
    assert tobj.smoothness_mu(loss) == jobj.smoothness_mu(loss)


def test_infeasible_duals_give_minus_inf_like_jax():
    y = np.array([[1.0, -1.0, 1.0, -1.0]], np.float32)
    alpha = np.array([[-0.5, 0.5, 0.5, -0.5]], np.float32)
    for loss in ("smoothed_hinge", "logistic"):
        np.testing.assert_array_equal(
            tobj.neg_conj(loss, torch.from_numpy(alpha), torch.from_numpy(y)).numpy(),
            np.asarray(jobj.neg_conj(loss, jnp.asarray(alpha), jnp.asarray(y))))


def test_convert_round_trips_problem_and_state():
    jp = jproblems.rcv1_like(K=2, d=64, n_per_worker=16)
    tp = convert.problem_from_arrays(np.asarray(jp.X), np.asarray(jp.y), jp.lam,
                                     device="cpu")
    X, y = convert.problem_to_arrays(tp)
    assert X.tobytes() == np.asarray(jp.X).tobytes()
    assert y.tobytes() == np.asarray(jp.y).tobytes()
    rng = np.random.default_rng(0)
    arrays = {name: rng.standard_normal((2, 64)).astype(np.float32)
              for name in convert.STATE_FIELDS}
    state = convert.state_from_arrays(arrays, device="cpu")
    arrays[convert.STATE_FIELDS[0]][0, 0] = 123.0  # the tensors own copies
    back = convert.state_to_arrays(state)
    assert set(back) == set(arrays)
    for name in convert.STATE_FIELDS[1:]:
        assert back[name].tobytes() == arrays[name].tobytes()
    assert back[convert.STATE_FIELDS[0]][0, 0] != 123.0
    with pytest.raises(ValueError, match="unknown state fields"):
        convert.state_from_arrays({"nope": arrays["alpha"]}, device="cpu")
    with pytest.raises(ValueError, match="need X"):
        convert.problem_from_arrays(np.zeros((2, 3)), np.zeros(2), 1e-3, device="cpu")


def test_entry_points_without_a_device_raise_when_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tproblems.rcv1_like(K=2, d=64, n_per_worker=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.problem_from_arrays(np.zeros((1, 2, 3)), np.zeros((1, 2)), 1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_arrays({"alpha": np.zeros((1, 2))})
    problem = tproblems.rcv1_like(K=2, d=64, n_per_worker=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacpd.run_method_reference(problem, tbaselines.cocoa_plus(2, H=4),
                                   ClusterModel(2), num_outer=1)


def test_run_refuses_a_problem_on_another_device():
    problem = tproblems.rcv1_like(K=2, d=64, n_per_worker=8, device="cpu")
    with pytest.raises(ValueError, match="build the problem on meta"):
        tacpd.run_method_reference(problem, tbaselines.cocoa_plus(2, H=4),
                                   ClusterModel(2), num_outer=1, device="meta")
