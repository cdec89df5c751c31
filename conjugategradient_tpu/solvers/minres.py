"""Device-resident MINRES for symmetric INDEFINITE systems.

Completes the Krylov family by symmetry class: CG (SPD,
``solvers.cg``), MINRES (symmetric indefinite, this module), BiCGStab /
GMRES (nonsymmetric, ``solvers.bicgstab`` / ``solvers.gmres``), CGNR
(anything, fallback).  The canonical workload is the Helmholtz operator
``-lap(u) - k^2 u`` (``core.generators.helmholtz_system``): symmetric but
with eigenvalues on both sides of zero, where CG's recurrence divides by
indefinite quadratic forms and fails.

Paige & Saunders (SIAM J. Numer. Anal. 12, 1975): Lanczos tridiagonal-
isation + on-the-fly Givens QR of the tridiagonal — a three-term
recurrence (constant memory, like CG; unlike GMRES) that minimises
``||b - A x||_2`` over the Krylov space at every step, monotonically.

Same architecture as every solver here: ONE jitted ``lax.while_loop``, all
scalars (the Givens rotation state, the residual estimate ``phibar``)
device-resident, zero host crossings per iteration.

Preconditioning: ``M`` must be SPD (it defines the inner product of the
preconditioned Lanczos process).  The loop then monitors the M-norm
``sqrt(r^T M r)`` — the natural quantity of preconditioned MINRES — while
the RETURNED residual/converged flag are re-evaluated from the true
``b - A x`` in the policy's norm, so a loose M cannot fake convergence.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.blas import dot as _dot
from conjugategradient_tpu.ops.blas import residual_norm
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, _apply_M, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def minres_loop(
    op,
    M: Optional[Callable],
    b: jnp.ndarray,
    x: jnp.ndarray,
    policy: ConvergencePolicy,
    dot: Callable,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
) -> CGResult:
    """The MINRES recurrence with INJECTED reductions — shared by the
    single-device driver below and the row-sharded form
    (``parallel.shard_nonsym``, which passes psum'd twins).  Same contract
    as ``solvers.gmres.gmres_loop``."""
    n = n_global if n_global is not None else b.size
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    r1 = b - op(x)
    rr0 = dot(r1, r1)
    y = _apply_M(M, r1)
    beta1 = jnp.sqrt(jnp.maximum(dot(r1, y), 0.0))  # ||r||_M
    zero = jnp.zeros_like(b)

    # the loop predicate monitors phibar (= ||r||_2 unpreconditioned,
    # ||r||_M with M); translate the policy tolerance onto that scale
    if policy.norm == "rel_l2":
        inner_tol = tol * beta1
    else:
        inner_tol = tol

    def cond(state):
        (_x, _r1, _r2, _y, _w, _w2, _oldb, beta, _dbar, _epsln, phibar,
         _cs, _sn, it) = state
        unconverged = jnp.logical_or(it < min_iter, phibar >= inner_tol)
        live = beta > 0  # Lanczos breakdown = exact convergence
        return jnp.logical_and(jnp.logical_and(unconverged, live), it < max_iter)

    def body(state):
        (x, r1, r2, y, w, w2, oldb, beta, dbar, epsln, phibar, cs, sn, it) = state
        v = _safe_div(1.0, beta) * y
        y2 = op(v)
        y2 = jnp.where(it >= 1, y2 - _safe_div(beta, oldb) * r1, y2)
        alfa = dot(v, y2)
        y2 = y2 - _safe_div(alfa, beta) * r2
        r1n, r2n = r2, y2
        yn = _apply_M(M, r2n)
        oldb_n = beta
        beta_n = jnp.sqrt(jnp.maximum(dot(r2n, yn), 0.0))

        # previous rotations applied to the new tridiagonal column,
        # then the new rotation eliminating beta_n
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.sqrt(gbar * gbar + beta_n * beta_n)
        gamma = jnp.maximum(gamma, jnp.asarray(1e-30, dtype))
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        w1 = w2
        w2n = w
        wn = _safe_div(1.0, gamma) * (v - oldeps * w1 - delta * w2n)
        xn = x + phi * wn
        return (xn, r1n, r2n, yn, wn, w2n, oldb_n, beta_n, dbar_n, epsln_n,
                phibar_n, cs_n, sn_n, it + 1)

    one = jnp.asarray(1.0, dtype)
    state0 = (
        x, r1, r1, y, zero, zero, one, beta1,
        jnp.zeros((), dtype), jnp.zeros((), dtype), beta1,
        -one, jnp.zeros((), dtype), jnp.int32(0),
    )
    state = jax.lax.while_loop(cond, body, state0)
    x, it = state[0], state[13]
    beta_final = state[7]

    # honest reporting: the TRUE residual in the policy norm
    r = b - op(x)
    if policy.norm == "linf" and pmax_abs is not None:
        res = pmax_abs(r)
    else:
        rr = dot(r, r)
        res = residual_norm(r, rr, rr0, policy.norm)
    # Lanczos breakdown (beta = 0) is exact convergence and may exit the
    # loop before min_iteration — it must not read as failure (cg/bicgstab
    # reach the same situation by iterating NaN-frozen steps instead)
    converged = jnp.logical_and(
        res < tol, jnp.logical_or(it >= min_iter, beta_final == 0)
    )
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def minres_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b (A symmetric, possibly indefinite) by MINRES.

    ``M``: optional SPD preconditioner application.  Returns a
    ``CGResult``; shape-agnostic (grid-shaped or flat b).
    """
    op = as_operator(A)
    dtype = b.dtype
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    return minres_loop(op, M, b, x, policy, dot=dot)
