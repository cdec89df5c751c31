"""Chebyshev iteration: the dot-product-free solver.

Every Krylov method here pays collective dot products each iteration (CG
2, BiCGStab 2-fused, MINRES 2); the communication-reduced variants
(``variant="cg1"|"pipelined"``) get that to one.  Chebyshev iteration
(Golub & Varga 1961) is the END of that axis: given spectral bounds
``[lo, hi]`` of SPD A, the optimal-polynomial recurrence needs NO inner
products at all — one SpMV and three AXPYs per iteration, coefficients
computed from the bounds alone.  Convergence checks (the only reductions)
run every ``check_every`` iterations, so the sharded form performs ONE
all-reduce per ``check_every`` halo-exchange SpMVs — the latency-bound
regime's (multi-host DCN) natural solver, and the classical foundation
under ``precond.chebyshev_smooth``.

The price: you must know the bounds (estimated here by setup-time Lanczos
with safety margins when not given), and convergence is slower than CG's
per iteration (Chebyshev is optimal among FIXED polynomials; CG adapts).
Same device-resident architecture as every sibling: one
``lax.while_loop`` over ``check_every``-iteration ``fori`` chunks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.blas import dot as _dot
from conjugategradient_tpu.ops.blas import residual_norm
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def chebyshev_loop(
    op,
    b: jnp.ndarray,
    x: jnp.ndarray,
    policy: ConvergencePolicy,
    lo: float,
    hi: float,
    dot,
    check_every: int = 16,
    pmax_abs=None,
    n_global: Optional[int] = None,
) -> CGResult:
    """The recurrence with injected reductions (shared single-device /
    sharded, like ``gmres_loop``/``minres_loop``)."""
    dtype = b.dtype
    n = n_global if n_global is not None else b.size
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    check = int(check_every)

    theta = jnp.asarray((hi + lo) / 2.0, dtype)
    delta = jnp.asarray((hi - lo) / 2.0, dtype)
    sigma = theta / delta

    r = b - op(x)
    rr0 = dot(r, r)

    def res_of(r, rr):
        if policy.norm == "linf" and pmax_abs is not None:
            return pmax_abs(r)
        return residual_norm(r, rr, rr0, policy.norm)

    def step(carry, _):
        x, r, d, rho_prev, it, started = carry
        # first step: d = r/theta; later: the two-term Chebyshev recurrence
        rho = 1.0 / (2.0 * sigma - rho_prev)
        d_new = jnp.where(
            started,
            rho * rho_prev * d + (2.0 * rho / delta) * r,
            r / theta,
        )
        rho_new = jnp.where(started, rho, 1.0 / sigma)
        active = it < max_iter
        d = jnp.where(active, d_new, d)
        x = jnp.where(active, x + d, x)
        r = jnp.where(active, r - op(d), r)
        rho_prev = jnp.where(active, rho_new, rho_prev)
        return (x, r, d, rho_prev, it + active.astype(jnp.int32), True), None

    def cond(state):
        _x, _r, _d, _rho, rr, it, _s = state
        res = res_of(_r, rr)
        return jnp.logical_and(
            jnp.logical_or(it < min_iter, res >= tol), it < max_iter
        )

    need_rr = not (policy.norm == "linf" and pmax_abs is not None)

    def body(state):
        x, r, d, rho_prev, rr, it, started = state
        (x, r, d, rho_prev, it, started), _ = jax.lax.scan(
            step, (x, r, d, rho_prev, it, started), None, length=check
        )
        # the ONE reduction per `check` iterations — skipped entirely for
        # linf, whose predicate pmax in `cond` is the reduction instead
        if need_rr:
            rr = dot(r, r)
        return (x, r, d, rho_prev, rr, it, started)

    zero = jnp.zeros_like(b)
    state = (x, r, zero, jnp.asarray(0.0, dtype), rr0, jnp.int32(0),
             jnp.asarray(False))
    x, r, d, rho_prev, rr, it, _ = jax.lax.while_loop(cond, body, state)
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def estimate_bounds(A, k: int = 40, widen: float = 0.1):
    """Setup-time spectral-bound estimate: host Lanczos widened by
    ``widen`` on each side (an UNDERestimated upper bound diverges the
    recurrence).  Shared by ``chebyshev_solve`` and the facade's sharded
    route, so both paths always use identical bounds for a given matrix."""
    from conjugategradient_tpu.core import oracle
    from conjugategradient_tpu.solvers.eigen import lanczos_bounds

    lo_e, hi_e = lanczos_bounds(
        lambda v: oracle.spmv(A, v), A.shape[0], k=min(A.shape[0], k)
    )
    return max(lo_e * (1.0 - widen), 1e-12 * hi_e), hi_e * (1.0 + widen)


def chebyshev_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    bounds: Optional[Tuple[float, float]] = None,
    check_every: int = 16,
    precise_dot: bool = False,
) -> CGResult:
    """Solve SPD ``A x = b`` by Chebyshev iteration.

    ``bounds``: (lambda_min, lambda_max) of A.  When None they are
    estimated at setup by 40-step host Lanczos and widened by 10% on each
    side — an UNDERestimated lambda_max diverges the recurrence (the
    polynomial is evaluated outside [-1, 1]), so bring real bounds for
    production use.  ``check_every`` trades convergence-detection latency
    against reduction count.
    """
    lo, hi = estimate_bounds(A) if bounds is None else bounds
    op = as_operator(A)
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    return chebyshev_loop(
        op, b, x, policy, float(lo), float(hi), dot, check_every=check_every
    )
