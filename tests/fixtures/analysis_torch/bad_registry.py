"""Seeded violations for the port's `registry-hooks` rule.

Linted as source only (never imported), so nothing here reaches the real
registries.
"""

from repro_torch.core.compress import Compressor, register_compressor
from repro_torch.core.delays import DelayModel, register_delay
from repro_torch.core.engine import Protocol, register_protocol
from repro_torch.core.solvers import LocalSolver, register_solver


@register_protocol("fixture_bad_proto")  # VIOLATION (missing hooks)
class IncompleteProtocol(Protocol):
    def num_rounds(self, R):
        return R


@register_protocol("fixture_unstated_sigma")  # VIOLATION (the two extras unstated)
class UnstatedSigma(Protocol):
    def num_rounds(self, R):
        return R

    def initial_messages(self):
        return []

    def arrivals_needed(self, r):
        return 1

    def process_round(self, r, arrived):
        return []

    def snapshot(self, it):
        return None

    def finalize(self, records):
        return None


@register_compressor("fixture_bad_comp")  # VIOLATION (missing hooks)
class IncompleteCompressor(Compressor):
    def compress(self, dw):
        return dw, dw


@register_delay("fixture_bad_delay")  # VIOLATION (no compute_time)
class NoComputeTime(DelayModel):
    pass


def jax_style_solver(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, key, *,
                     loss, num_steps):
    return alpha


def draw_too_few(keys, *, n_k, num_steps, device):
    return [keys]


def solve_ok(orders, w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, *, loss,
             cells=1, map_error=None):
    return alpha


register_solver("fixture_jax_style")(jax_style_solver)  # VIOLATION (no draws)
register_solver("fixture_bad_local")(LocalSolver(draw_too_few, solve_ok))  # VIOLATION


def port_solver(w_all, alpha, X, y, norms_sq, lam, n_global, sigma_prime, keys, draws, *,
                loss, num_steps):
    return alpha


def draw_ok(keys, draws, *, n_k, num_steps, device, **_):
    return [keys]


GOOD = LocalSolver(draw_ok, solve_ok)
register_solver("fixture_good")(port_solver)
register_solver("fixture_good_local")(GOOD)
