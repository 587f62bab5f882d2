"""Port vs JAX package: the optimizers (``optim/optimizers.py``).

``lr_at`` for each schedule, ``clip_by_global_norm``, and AdamW and SGD
steps on float32 and bfloat16 leaves, from the same numpy parameters,
gradients and moments in both packages. Float32 results agree within rtol
1e-6 (``pow``, ``sqrt`` and the norm's sum may differ in their last bit
between the libraries, and the clip scale with them) and atol 1e-7 (a
moment that cancels to near 0 keeps the absolute error of its O(1) terms,
a few float32 ulps of 0.5); bfloat16 parameters are computed in float32 and
cast once, so they agree to one bfloat16 rounding step (rtol 2**-7) and are
equal almost everywhere.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.models.param import tree_flatten
from repro_torch.optim import optimizers as topt


def _np_tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(dtype),
            "b": {"z": (rng.standard_normal(17) * scale).astype(dtype),
                  "a": (rng.standard_normal((2, 3, 4)) * scale).astype(dtype)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else np.asarray(x)
                      .astype(np.float32))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=4, total_steps=20, schedule=schedule)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    for s in range(0, 25):
        np.testing.assert_allclose(float(topt.lr_at(tc, torch.tensor(s, dtype=torch.int32))),
                                   float(jopt.lr_at(jc, jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0), (1.0, 100.0)])
def test_clip_by_global_norm_matches_jax(scale, max_norm):
    g = _np_tree(1, scale=scale)
    jg, jn = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tree_flatten(tg)[0], tree_flatten(jg)[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_update_steps_match_jax(name, dtype):
    kw = dict(name=name, learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=5.0)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    params = _np_tree(2, dtype)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.init_state(jc, jp), topt.init_state(tc, tp)
    assert ts.step.dtype == torch.int32 and (ts.nu is None) == (name == "sgd")
    for step in range(4):
        grads = _np_tree(10 + step, dtype if step % 2 else np.float32, scale=2.0)
        jp, js, jm = jopt.apply_update(jc, jp, _to_jax(grads), js)
        tp, ts, tm = topt.apply_update(tc, tp, _to_torch(grads), ts)
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(tree_flatten(ts.mu)[0], tree_flatten(js.mu)[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        rtol = 1e-6 if dtype == np.float32 else 2.0**-7
        for a, b in zip(tree_flatten(tp)[0], tree_flatten(jp)[0]):
            assert a.dtype == (torch.float32 if dtype == np.float32 else torch.bfloat16)
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=rtol, atol=1e-7)
