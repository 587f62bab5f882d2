"""An RCV1-like sparse problem made on the device from a seed.

The distribution of ``data/synthetic.py`` (the port's and the JAX
package's generator), vectorised: each row has max(4, Poisson(nnz_per_row))
nonzeros, whose columns are drawn without replacement with Zipf(exponent)
feature popularity (Gumbel top-k, which draws exactly as sequential weighted
sampling without replacement does), standard normal values, and unit norm.
Labels come from a sparse ground-truth predictor over d // 64 features,
sign(X w*) with a share ``label_noise`` flipped. The rows are i.i.d., so the
generator's final shuffle changes no distribution and is left out. ``X`` is
dense float32, as the port stores it; it is made in blocks of rows so that
the largest temporary is one block's draws.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 2048


def make(config: dict, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``X (K, n_k, d)`` and ``y (K, n_k)``, float32, on ``device``."""
    K, n_k, d = config["workers"], config["rows_per_worker"], config["num_features"]
    n = K * n_k
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    logp = -config["feature_zipf"] * torch.log(
        torch.arange(1, d + 1, dtype=torch.float32, device=device))
    rate = torch.full((n,), float(config["nnz_per_row"]), device=device)
    nnz = torch.clamp(torch.poisson(rate, generator=g), min=4, max=d).long()
    width = int(nnz.max())
    X = torch.zeros((n, d), dtype=torch.float32, device=device)
    for lo in range(0, n, ROW_BLOCK):
        hi = min(n, lo + ROW_BLOCK)
        u = torch.rand((hi - lo, d), generator=g, device=device).clamp_(min=1e-30)
        keys = logp - torch.log(-torch.log(u))
        del u
        cols = torch.topk(keys, width, dim=1).indices
        del keys
        vals = torch.randn((hi - lo, width), generator=g, device=device)
        keep = torch.arange(width, device=device)[None, :] < nnz[lo:hi, None]
        X[lo:hi].scatter_(1, cols, torch.where(keep, vals, torch.zeros_like(vals)))
    X /= torch.clamp(torch.linalg.vector_norm(X, dim=1, keepdim=True), min=1e-8)
    support = torch.randperm(d, generator=g, device=device)[:max(8, d // 64)]
    w_star = torch.zeros(d, dtype=torch.float32, device=device)
    w_star[support] = torch.randn(support.numel(), generator=g, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        margin = X @ w_star
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = torch.sign(margin + 1e-9)
    flip = torch.rand(n, generator=g, device=device) < config["label_noise"]
    y = torch.where(flip, -y, y)
    y = torch.where(y == 0, torch.ones_like(y), y)
    return X.reshape(K, n_k, d), y.reshape(K, n_k)
