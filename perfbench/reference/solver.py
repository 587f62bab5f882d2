"""The solver cells' plain reference: ACPD's B-of-K server and CoCoA+.

Plain PyTorch on the benchmark's own inputs; it imports nothing of the
program. It follows the published protocols (Huo & Huang 2019, Alg. 1-2;
Ma et al. 2015) as the configuration and traffic files state them:

* workers run H sequential SDCA coordinate steps (ridge: delta = (y - a -
  z) / (1 + q), z = (w_eff + sigma' v)^T x_i, q = sigma' ||x_i||^2 /
  (lambda n)) along the visit orders of :mod:`perfbench.inputs.draws`;
* ``group``: each worker sends the exactly-k largest |dw| (ties toward the
  lower index; k = ceil(rho d)) and keeps the rest as its residual; the
  server applies the first B arrivals in (arrival time, send order), a
  full barrier every T-th round, replies with its catch-up buffer (8 bytes
  a nonzero), and the clock is the straggler model's: H unit_time sigma_k
  of compute, latency + bytes / bandwidth a message;
* ``sync`` (CoCoA+): all K workers a round, w += gamma sum v, the round
  timed as max compute plus a ring allreduce;
* every eval boundary is scored by its duality-gap certificate in two
  passes over X.

``precision`` puts every product (the coordinate steps' dot products and
the certificates' passes) in that precision (:mod:`.numerics`).
"""

from __future__ import annotations

import heapq
import math

import torch

from perfbench.inputs.draws import Draws
from perfbench.reference.numerics import matmul


def _lam_n(lam: float, n: int) -> float:
    """lambda n as a float32 product."""
    return float(torch.tensor(lam, dtype=torch.float32) * torch.tensor(float(n)))


class _Problem:
    def __init__(self, X, y, lam, loss, precision):
        if loss != "ridge":
            raise ValueError(f"the reference solves ridge only, not {loss!r}")
        self.X, self.y, self.lam = X, y, lam
        self.K, self.n_k, self.d = X.shape
        self.n = self.K * self.n_k
        self.lam_n = _lam_n(lam, self.n)
        self.precision = precision
        self.norms_sq = torch.stack([torch.sum(X[k] * X[k], dim=-1) for k in range(self.K)])

    def dot_rows(self, a, b):
        """Row-wise dot products of (B, d) tensors."""
        return matmul(a[:, None, :], b[:, :, None], self.precision)[:, 0, 0]

    def sdca(self, workers, w_eff, alpha, orders, sigma):
        """H steps for the batch ``workers`` from ``alpha``: (dalpha (B, n_k), v (B, d))."""
        B, H = orders.shape
        rows = torch.as_tensor(workers, device=self.X.device, dtype=torch.long)
        b = torch.arange(B, device=self.X.device)
        dalpha = torch.zeros((B, self.n_k), dtype=torch.float32, device=self.X.device)
        v = torch.zeros_like(w_eff)
        orders = orders.long()
        for h in range(H):
            i = orders[:, h]
            x = self.X[rows, i]
            a = alpha[rows, i] + dalpha[b, i]
            z = self.dot_rows(w_eff, x) + sigma * self.dot_rows(v, x)
            q = sigma * self.norms_sq[rows, i] / self.lam_n
            delta = (self.y[rows, i] - a - z) / (1.0 + q)
            dalpha[b, i] += delta
            v = v + (delta / self.lam_n)[:, None] * x
        return dalpha, v

    def certificates(self, ws, alphas):
        """(primal, dual, gap, gap_server) per snapshot, ridge."""
        S = ws.shape[0]
        Xg, yg = self.X.reshape(self.n, self.d), self.y.reshape(self.n)
        A = alphas.reshape(S, self.n)
        w_alpha = matmul(A, Xg, self.precision) / self.lam_n
        W = torch.cat([w_alpha, ws])
        z = matmul(Xg, W.T, self.precision)
        primal = (0.5 * (z - yg[:, None]) ** 2).sum(0) / self.n + 0.5 * self.lam * (W * W).sum(-1)
        dual = ((A * yg[None] - 0.5 * A * A).sum(-1) / self.n
                - 0.5 * self.lam * (w_alpha * w_alpha).sum(-1))
        p, p_srv = primal[:S], primal[S:]
        return p, dual, p - dual, p_srv - dual


def _records(prob, snaps):
    ws = torch.stack([s["w"] for s in snaps])
    alphas = torch.stack([s["alpha"] for s in snaps])
    p, dv, gap, gap_srv = (t.tolist() for t in prob.certificates(ws, alphas))
    keys = ("iteration", "sim_time", "bytes_up", "bytes_down", "compute_time", "comm_time")
    return [dict({k: s[k] for k in keys}, primal=p[j], dual=dv[j], gap=gap[j],
                 gap_server=gap_srv[j]) for j, s in enumerate(snaps)]


def _topk_exact(dw, k):
    """(sent, residual): the k largest |dw| of each row, ties toward the lower index."""
    idx = torch.sort(torch.abs(dw), dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros(dw.shape, dtype=torch.bool, device=dw.device)
    mask.scatter_(-1, idx, True)
    sent = torch.where(mask, dw, torch.zeros_like(dw))
    return sent, dw - sent


def run_group(prob: _Problem, cluster: dict, method: dict, draws: Draws, num_outer: int):
    K, n_k, d, dev = prob.K, prob.n_k, prob.d, prob.X.device
    B, T, H, gamma = method["B"], method["T"], method["H"], method["gamma"]
    sigma = method["sigma_prime"]
    rho = min(1.0, method["rho_d"] / d)
    dense = rho >= 1.0
    k_keep = max(1, min(d, math.ceil(rho * d)))
    up_bytes = d * 4 if dense else k_keep * 8
    unit, lat, bw = cluster["unit_time"], cluster["latency"], cluster["bandwidth"]
    sig = [cluster["straggler_sigma"] if k in cluster["straggler_workers"] else 1.0
           for k in range(K)]
    z = dict(dtype=torch.float32, device=dev)
    w_server, dw_tilde = torch.zeros(d, **z), torch.zeros((K, d), **z)
    w_local, residual = torch.zeros((K, d), **z), torch.zeros((K, d), **z)
    alpha, alpha_applied = torch.zeros((K, n_k), **z), torch.zeros((K, n_k), **z)
    acct = {"bytes_up": 0, "bytes_down": 0, "compute_time": 0.0, "comm_time": 0.0,
            "sim_time": 0.0, "seq": 0}
    queue: list = []

    def launch(starts, billing):
        ws = [k for k, _ in starts]
        idx = torch.as_tensor(ws, device=dev, dtype=torch.long)
        orders = draws.randint([None] * len(ws), n_k, H)
        w_eff = w_local[idx] + gamma * residual[idx]
        dalpha, v = prob.sdca(ws, w_eff, alpha, orders, sigma)
        rows = alpha[idx] + gamma * dalpha
        alpha[idx] = rows
        dw = residual[idx] + v
        sent, new_res = (dw, torch.zeros_like(dw)) if dense else _topk_exact(dw, k_keep)
        residual[idx] = new_res
        for j, (k, start) in enumerate(starts):
            if billing is not None:
                acct["bytes_down"] += billing[j][0]
                acct["comm_time"] += billing[j][1]
            duration = H * unit * sig[k]
            up_time = lat + up_bytes / bw
            acct["compute_time"] += duration
            acct["comm_time"] += up_time
            acct["bytes_up"] += up_bytes
            acct["seq"] += 1
            heapq.heappush(queue, (start + duration + up_time, acct["seq"], k, sent[j], rows[j]))

    launch([(k, 0.0) for k in range(K)], None)
    snaps = []
    for r in range(num_outer * T):
        need = K if r % T == T - 1 else min(B, K)
        arrived = [heapq.heappop(queue) for _ in range(need)]
        server_time = max(m[0] for m in arrived)
        ws = [m[2] for m in arrived]
        idx = torch.as_tensor(ws, device=dev, dtype=torch.long)
        total = torch.zeros_like(w_server)
        for m in arrived:
            total = total + m[3]
        w_server = w_server + gamma * total
        dw_tilde = dw_tilde + gamma * total[None, :]
        alpha_applied = alpha_applied.index_copy(0, idx, torch.stack([m[4] for m in arrived]))
        replies = dw_tilde[idx]
        nnz = torch.sum(replies != 0, dim=1).tolist()
        w_local[idx] = w_local[idx] + replies
        dw_tilde[idx] = 0.0
        starts, billing = [], []
        for j, k in enumerate(ws):
            rbytes = d * 4 if dense else int(nnz[j]) * 8
            down = lat + rbytes / bw
            starts.append((k, server_time + down))
            billing.append((rbytes, down))
        acct["sim_time"] = server_time
        launch(starts, billing)
        snaps.append(dict({k: acct[k] for k in ("bytes_up", "bytes_down", "compute_time",
                                                 "comm_time", "sim_time")},
                          iteration=r + 1, w=w_server, alpha=alpha_applied.clone()))
    return {"records": _records(prob, snaps), "w": w_server, "alpha": alpha,
            "alpha_applied": alpha_applied}


def run_sync(prob: _Problem, cluster: dict, method: dict, draws: Draws, num_outer: int):
    K, n_k, d, dev = prob.K, prob.n_k, prob.d, prob.X.device
    H, gamma, sigma = method["H"], method["gamma"], method["sigma_prime"]
    unit, lat, bw = cluster["unit_time"], cluster["latency"], cluster["bandwidth"]
    sig = [cluster["straggler_sigma"] if k in cluster["straggler_workers"] else 1.0
           for k in range(K)]
    w = torch.zeros(d, dtype=torch.float32, device=dev)
    alpha = torch.zeros((K, n_k), dtype=torch.float32, device=dev)
    step_comm = (2.0 * (K - 1) / K * d * 4 / bw + 2.0 * math.ceil(math.log2(K)) * lat
                 if K > 1 else 0.0)
    phase = (K - 1) * d * 4
    sim = comp = comm = 0.0
    bu = bd = 0
    snaps = []
    for r in range(num_outer):
        orders = draws.randint([None] * K, n_k, H)
        dalpha, v = prob.sdca(list(range(K)), w.expand(K, d).contiguous(), alpha, orders, sigma)
        w, alpha = w + gamma * torch.sum(v, dim=0), alpha + gamma * dalpha
        step_compute = max(H * unit * s for s in sig)
        sim += step_compute + step_comm
        comp += step_compute
        comm += step_comm
        bu += phase
        bd += phase
        snaps.append(dict(iteration=r + 1, sim_time=sim, bytes_up=bu, bytes_down=bd,
                          compute_time=comp, comm_time=comm, w=w, alpha=alpha))
    return {"records": _records(prob, snaps), "w": w, "alpha": alpha, "alpha_applied": None}


def run(X, y, config: dict, traffic: dict, run_seed: int, precision: str = "float32") -> dict:
    """One run of the traffic's method from ``run_seed``, as the program's
    ``Session(...).run()`` reports it: records, final w and alpha."""
    prob = _Problem(X, y, config["lam"], config["loss"], precision)
    method = traffic["method"]
    draws = Draws(run_seed, X.device)
    protocol = {"group": run_group, "sync": run_sync}[method["protocol"]]
    with torch.no_grad():
        return protocol(prob, config["cluster"], method, draws, traffic["num_outer"])
