"""sdca_inner.roofline (%): the SDCA kernel's least time over its device time.

Counted work is what the run's protocol needs, not the launches the program
makes: ``worker_epochs`` per run (ACPD: K at the start, then B a round and K
at each T-th; CoCoA+: K a round), and per worker-epoch the bytes of
``epoch_bytes`` or 6 d H float32 operations, whichever takes longer at the
card's peaks. The device time is every kernel of the ``sdca_inner``
library in the traced window.
"""


def worker_epochs(config: dict, traffic: dict) -> int:
    m, K = traffic["method"], config["workers"]
    if m["protocol"] == "group":
        rounds = traffic["num_outer"] * m["T"]
        return K + sum(K if r % m["T"] == m["T"] - 1 else min(m["B"], K)
                       for r in range(rounds))
    return traffic["num_outer"] * K


def epoch_bytes(config: dict, traffic: dict) -> float:
    """One worker's H steps: the distinct rows they visit (expected count
    of n_k (1 - (1 - 1/n_k)^H) for uniform orders), read whole from the
    dense X with their label and squared norm; w_eff read and v written
    (d each); alpha read and dalpha written (n_k each); the visit order."""
    d, n_k, H = config["num_features"], config["rows_per_worker"], traffic["method"]["H"]
    rows = n_k * (1.0 - (1.0 - 1.0 / n_k) ** H)
    return 4.0 * (rows * (d + 2) + 2 * d + 2 * n_k + H)


def epoch_flops(config: dict, traffic: dict) -> float:
    return 6.0 * config["num_features"] * traffic["method"]["H"]


def bound_s(config: dict, traffic: dict, peaks: dict) -> float:
    """Least device seconds of one run's worker-epochs."""
    per = max(epoch_bytes(config, traffic) / peaks["hbm_bytes_per_s"],
              epoch_flops(config, traffic) / peaks["float32_flops"])
    return worker_epochs(config, traffic) * per


def read(ctx):
    t = ctx.kernel_seconds("sdca")
    if t <= 0 or ctx.units == 0:
        return None
    return 100.0 * ctx.units * bound_s(ctx.config, ctx.traffic, ctx.peaks) / t
