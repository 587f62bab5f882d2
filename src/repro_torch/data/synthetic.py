"""Deterministic synthetic datasets (PyTorch counterpart of
``repro.data.synthetic``).

The paper's LIBSVM datasets (RCV1/URL/KDD) are stood in for by a generator
that reproduces their salient property for this paper: high-dimensional,
sparse, normalized rows (``||x_i|| <= 1``, Assumption 1), Zipf feature
frequencies and labels from a sparse ground-truth predictor plus noise.

The generator is the JAX package's numpy code, draw for draw, so ``X`` and
``y`` are byte-identical to ``repro``'s for the same spec. The only change is
that rows are normalized in place, which gives the same bytes and saves one
host copy of ``X``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.objectives import Problem
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearDatasetSpec:
    num_workers: int = 4
    n_per_worker: int = 512
    d: int = 8192
    nnz_per_row: int = 64  # average sparsity like RCV1 (~0.1%)
    label_noise: float = 0.05
    task: str = "classification"  # or "regression"
    seed: int = 0


def make_linear_arrays(spec: LinearDatasetSpec) -> tuple[np.ndarray, np.ndarray]:
    """The host arrays ``X (K, n_k, d)`` and ``y (K, n_k)``, float32."""
    rng = np.random.default_rng(spec.seed)
    K, n_k, d = spec.num_workers, spec.n_per_worker, spec.d
    n = K * n_k

    # Zipf-distributed feature popularity: low-index features are common.
    popularity = 1.0 / np.arange(1, d + 1) ** 0.8
    popularity /= popularity.sum()

    X = np.zeros((n, d), np.float32)
    for i in range(n):
        nnz = max(4, int(rng.poisson(spec.nnz_per_row)))
        cols = rng.choice(d, size=min(nnz, d), replace=False, p=popularity)
        vals = rng.normal(size=cols.size).astype(np.float32)
        X[i, cols] = vals
    row_norms = np.linalg.norm(X, axis=1, keepdims=True)
    np.divide(X, np.maximum(row_norms, 1e-8), out=X)  # ||x_i|| = 1

    # Sparse ground-truth predictor.
    w_star = np.zeros(d, np.float32)
    support = rng.choice(d, size=max(8, d // 64), replace=False)
    w_star[support] = rng.normal(size=support.size).astype(np.float32)
    margin = X @ w_star
    if spec.task == "classification":
        flip = rng.random(n) < spec.label_noise
        y = np.sign(margin + 1e-9).astype(np.float32)
        y[flip] *= -1.0
        y[y == 0] = 1.0
    else:
        y = (margin + spec.label_noise * rng.normal(size=n)).astype(np.float32)

    # Shuffle, then partition evenly across K workers (paper Sec. II-B).
    perm = rng.permutation(n)
    X, y = X[perm], y[perm]
    return X.reshape(K, n_k, d), y.reshape(K, n_k)


def make_linear_problem(spec: LinearDatasetSpec, lam: float = 1e-4,
                        loss: str = "ridge", *,
                        device: str | torch.device | None = None) -> Problem:
    """Build a K-partitioned Problem with ||x_i||_2 <= 1 on ``device``."""
    dev = resolve_device(device)
    X, y = make_linear_arrays(spec)
    return Problem(X=torch.from_numpy(X).to(dev), y=torch.from_numpy(y).to(dev),
                   lam=lam, loss=loss)  # type: ignore[arg-type]


def make_token_dataset(num_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed token stream (int32), draw for draw the JAX package's."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    p = 1.0 / ranks**1.1
    p /= p.sum()
    return rng.choice(vocab_size, size=num_tokens, p=p).astype(np.int32)
