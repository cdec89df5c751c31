"""Device-resident (preconditioned) BiCGStab for nonsymmetric systems.

The reference is CG-only — its fixtures are all symmetric (SURVEY.md §6) —
but a sparse-solver framework meets nonsymmetric operators the moment a
convection term appears (``core.generators.convection_diffusion_system``).
BiCGStab (van der Vorst, SIAM J. Sci. Stat. Comput. 13, 1992) is the
short-recurrence workhorse for that case: two SpMVs + four dots per
iteration, constant memory, no restart parameter.

Architecture mirrors ``solvers.cg``: the WHOLE loop is one jitted
``lax.while_loop`` — matrices enter as pytree arguments, scalars (rho,
alpha, omega, the residual) never leave the device, and the convergence
predicate is evaluated on the device (the placement lesson of
``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:201-270``).

Preconditioning is right-sided: ``A M^-1 (M x) = b``, applied as
``p_hat = M(p)``, ``s_hat = M(s)`` inside the recurrence — so the residual
the loop monitors is the TRUE residual of A x = b, and any linear ``M``
accepted by ``solvers.cg`` (Jacobi, Chebyshev, a multigrid V-cycle) drops
in unchanged.

Breakdown (rho -> 0 or t.t -> 0) cannot raise mid-``while_loop``; the
recurrence stays NaN-free via ``_safe_div`` (a zero denominator freezes the
affected update) and the returned ``converged`` flag reports the truth —
the same XLA-legal encoding of the reference's ApplicationException used by
``CGResult`` (``ConjugateGradient.cs:73``).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.blas import dot as _dot
from conjugategradient_tpu.ops.blas import residual_norm
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, _apply_M, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def bicgstab_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b (A square, possibly nonsymmetric) by right-
    preconditioned BiCGStab, fully on device.

    ``M`` is the preconditioner application ``z = M(r)`` (callable or the
    ``(fn, state)`` pytree-argument pair — see ``solvers.cg._apply_M``);
    it must be a fixed LINEAR operator.  Returns a ``CGResult``; shape-
    agnostic like ``cg_solve`` (grid-shaped or flat b).
    """
    op = as_operator(A)
    n = b.size
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    dot = lambda u, v: _dot(u, v, precise=precise_dot)

    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    r = b - op(x)
    rhat = r  # fixed shadow residual r0*
    rr0 = dot(r, r)
    one = jnp.asarray(1.0, dtype)
    zero = jnp.zeros_like(b)

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    def cond(state):
        _x, r, _p, _v, _rho, _alpha, _omega, rr, it = state
        unconverged = jnp.logical_or(it < min_iter, res_of(r, rr) >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    def body(state):
        x, r, p, v, rho, alpha, omega, rr, it = state
        rho_new = dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = _apply_M(M, p)
        v = op(p_hat)
        alpha = _safe_div(rho_new, dot(rhat, v))
        s = r - alpha * v
        s_hat = _apply_M(M, s)
        t = op(s_hat)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, dot(r, r), it + 1)

    state = (x, r, zero, zero, one, one, one, rr0, jnp.int32(0))
    x, r, p, v, rho, alpha, omega, rr, it = jax.lax.while_loop(cond, body, state)
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def bicgstab_solve_traced(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    num_steps: int = 100,
    precise_dot: bool = False,
):
    """Fixed-length BiCGStab recording the residual at every iteration —
    the nonsymmetric twin of ``cg_solve_traced`` (one ``lax.scan``, frozen
    steps after convergence, dense ``(num_steps,)`` history back in one
    device array; feed ``utils.reslog.records_from_history``).

    Returns ``(CGResult, residual_history)``.  Entries past ``iterations``
    are from frozen steps; truncate before use.
    """
    op = as_operator(A)
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)

    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    r = b - op(x)
    rhat = r
    rr0 = dot(r, r)
    one = jnp.asarray(1.0, dtype)
    zero = jnp.zeros_like(b)

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    def raw(state):
        x, r, p, v, rho, alpha, omega, rr = state
        rho_new = dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = _apply_M(M, p)
        v = op(p_hat)
        alpha = _safe_div(rho_new, dot(rhat, v))
        s = r - alpha * v
        s_hat = _apply_M(M, s)
        t = op(s_hat)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, dot(r, r))

    def step(state, _):
        *vec_state, it = state
        active = jnp.logical_or(
            it < min_iter, res_of(vec_state[1], vec_state[7]) >= tol
        )
        new = raw(tuple(vec_state))
        sel = lambda a, b: jnp.where(active, a, b)
        merged = tuple(sel(a, b) for a, b in zip(new, vec_state))
        it = it + active.astype(jnp.int32)
        return (*merged, it), res_of(merged[1], merged[7])

    state0 = (x, r, zero, zero, one, one, one, rr0, jnp.int32(0))
    state, history = jax.lax.scan(step, state0, None, length=num_steps)
    *vec_state, it = state
    res = res_of(vec_state[1], vec_state[7])
    converged = jnp.logical_and(res < tol, it >= min_iter)
    result = CGResult(x=vec_state[0], iterations=it, residual=res, converged=converged)
    return result, history
