"""LSMR: iterative least squares ``min ||A x - b||_2`` for rectangular A.

The reference's solvers are all square-SPD CG (SURVEY.md §0); a sparse
linear-algebra framework also meets OVER/UNDER-determined systems —
regression on sparse features, PDE-constrained data fitting, deconvolution.
LSMR (Fong & Saunders, SIAM J. Sci. Comput. 33(5), 2011) is the modern
workhorse: Golub–Kahan bidiagonalization with a double QR factorization,
algebraically equivalent to MINRES on the normal equations ``A^T A x =
A^T b`` but numerically far better behaved, with monotonically decreasing
``||A^T r||`` whose value falls out of the recurrence for free (it is
``|zetabar|`` — the stopping test costs nothing).

Device shape: one SpMV with A and one with A^T per iteration (the transpose is
built ONCE on host, ``core.formats.transpose``, and rides as a second
operator argument), everything else is axpys and scalar rotations inside one
jitted ``lax.while_loop`` — the same zero-host-crossings architecture as
every solver here.  Works for square nonsingular systems too (then it is a
better-conditioned CGNR); for consistent square systems prefer
BiCGStab/GMRES (fewer matrix passes per digit).

``damp`` solves the regularized problem ``min ||A x - b||^2 + damp^2
||x||^2`` (ridge/Tikhonov) by the standard LSMR damping recurrence — the
damped rotations are exact, not a perturbation; the monitored (and
returned) optimality residual is then ``||A^T r - damp^2 x||``, the
damped problem's own stationarity condition.  With ``x0`` the damping
regularizes the CORRECTION ``x - x0`` (the standard shifted form).

Convergence: the loop monitors the normal-equation residual —
``norm="rel_l2"`` (default sense) stops at ``||A^T r|| / ||A^T b|| < tol``,
``norm="l2"`` at ``||A^T r|| < tol``.  (``||A^T r|| -> 0`` is THE
least-squares optimality condition; ``||r||`` itself does not go to zero for
inconsistent systems.)  The returned ``residual`` reports the final TRUE
``||A^T r||`` in that sense, re-evaluated outside the loop.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core.formats import transpose
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def _norm(v):
    return jnp.sqrt(jnp.vdot(v, v, precision=MATMUL_PRECISION, preferred_element_type=v.dtype).real)


def lsmr_loop(
    op,
    opT,
    b_eff: jnp.ndarray,
    policy: ConvergencePolicy,
    damp: float = 0.0,
    n_iter_scale: Optional[int] = None,
    nrm=None,
):
    """The LSMR recurrence with an injectable 2-norm — the ``gmres_loop``
    sharing pattern: the single-device solver passes the local ``_norm``,
    the row-sharded twin (``parallel.shard_nonsym.sharded_lsmr_loop``)
    passes a psum-reduced norm and shard-local operators.  The norm is the
    ONLY reduction in the recurrence (two calls per iteration: beta and
    alpha of the bidiagonalization), so distribution costs exactly two
    collectives per iteration on top of the SpMV halos.

    Returns ``(x, iterations, res_final, converged, normar0)`` where ``x``
    solves the (possibly damped) problem against ``b_eff``.
    """
    if policy.norm == "linf":
        raise ValueError("lsmr monitors ||A^T r||; use norm='l2' or 'rel_l2'")
    nrm = nrm or _norm
    dtype = b_eff.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n_iter_scale or b_eff.size))
    dampj = jnp.asarray(damp, dtype)

    # --- Golub-Kahan init --------------------------------------------------
    beta = nrm(b_eff)
    u = b_eff * _safe_div(jnp.asarray(1.0, dtype), beta)
    v_un = opT(u)
    alpha = nrm(v_un)
    v = v_un * _safe_div(jnp.asarray(1.0, dtype), alpha)

    zetabar = alpha * beta  # = ||A^T r_0||
    normar0 = jnp.abs(zetabar)
    alphabar = alpha
    rho = jnp.asarray(1.0, dtype)
    rhobar = jnp.asarray(1.0, dtype)
    cbar = jnp.asarray(1.0, dtype)
    sbar = jnp.asarray(0.0, dtype)
    h = v
    hbar = jnp.zeros_like(v)
    x = jnp.zeros_like(v)

    def res_of(zetabar):
        ar = jnp.abs(zetabar)
        if policy.norm == "rel_l2":
            return ar / jnp.where(normar0 == 0, 1.0, normar0)
        return ar

    def cond(state):
        (x, u, v, h, hbar, alpha, alphabar, rho, rhobar, cbar, sbar,
         zetabar, it) = state
        unconverged = jnp.logical_or(it < min_iter, res_of(zetabar) >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    def body(state):
        (x, u, v, h, hbar, alpha, alphabar, rho, rhobar, cbar, sbar,
         zetabar, it) = state
        # bidiagonalization step (raw alpha_k, NOT the rotated alphabar)
        u_un = op(v) - alpha * u
        beta = nrm(u_un)
        u = u_un * _safe_div(jnp.asarray(1.0, dtype), beta)
        v_un = opT(u) - beta * v
        alpha_new = nrm(v_un)
        v_new = v_un * _safe_div(jnp.asarray(1.0, dtype), alpha_new)

        # fold the damping into the rotation (Fong & Saunders: eliminate
        # damp against alphabar first; only alphahat is consumed below)
        alphahat = jnp.sqrt(alphabar * alphabar + dampj * dampj)

        # rotation P_k: eliminate beta_{k+1}
        rhoold = rho
        rho_new = jnp.sqrt(alphahat * alphahat + beta * beta)
        c = _safe_div(alphahat, rho_new)
        s = _safe_div(beta, rho_new)
        thetanew = s * alpha_new
        alphabar_new = c * alpha_new

        # rotation Pbar_k: the second QR
        rhobarold = rhobar
        thetabar = sbar * rho_new
        rhotemp = cbar * rho_new
        rhobar_new = jnp.sqrt(rhotemp * rhotemp + thetanew * thetanew)
        cbar_new = _safe_div(rhotemp, rhobar_new)
        sbar_new = _safe_div(thetanew, rhobar_new)
        zeta = cbar_new * zetabar
        zetabar_new = -sbar_new * zetabar

        # solution update
        hbar_new = h - _safe_div(thetabar * rho_new, rhoold * rhobarold) * hbar
        x_new = x + _safe_div(zeta, rho_new * rhobar_new) * hbar_new
        h_new = v_new - _safe_div(thetanew, rho_new) * h

        return (
            x_new, u, v_new, h_new, hbar_new, alpha_new, alphabar_new,
            rho_new, rhobar_new, cbar_new, sbar_new, zetabar_new, it + 1,
        )

    state = (x, u, v, h, hbar, alpha, alphabar, rho, rhobar, cbar, sbar,
             zetabar, jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    x = state[0]
    it, zetabar_f = state[12], state[11]
    # true optimality residual of the (possibly damped, possibly shifted)
    # problem the loop actually solved, outside the loop (the recurrence
    # estimate drifts at high iteration counts; report ground truth):
    # min ||A dx - b_eff||^2 + damp^2 ||dx||^2  has optimality
    # A^T (b_eff - A dx) - damp^2 dx = 0 — which is what |zetabar| tracks
    ar_true = nrm(opT(b_eff - op(x)) - (dampj * dampj) * x)
    if policy.norm == "rel_l2":
        res = ar_true / jnp.where(normar0 == 0, 1.0, normar0)
    else:
        res = ar_true
    converged = jnp.logical_and(res_of(zetabar_f) < tol, it >= min_iter)
    return x, it, res, converged, normar0


def lsmr_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    damp: float = 0.0,
) -> CGResult:
    """Minimize ``||A x - b||`` (A of shape (m, n), any m/n) by LSMR.

    ``x0`` warm-starts via the standard shift (solve for ``dx`` against
    ``b - A x0``).  Returns a ``CGResult`` whose ``x`` has shape (n,) and
    whose ``residual``/``converged`` refer to the normal-equation residual
    ``||A^T (b - A x)||`` (see module docstring).
    """
    A_t = transpose(A)
    dtype = b.dtype
    A_dev = A.device_put(dtype=dtype) if hasattr(A, "device_put") else A
    At_dev = A_t.device_put(dtype=dtype) if hasattr(A_t, "device_put") else A_t
    op = as_operator(A_dev)
    opT = as_operator(At_dev)
    m, n = A.shape
    b_eff = b if x0 is None else b - op(x0.astype(dtype))
    x, it, res, converged, _ = lsmr_loop(
        op, opT, b_eff, policy, damp=damp, n_iter_scale=max(m, n)
    )
    if x0 is not None:
        # damp regularizes the CORRECTION dx when warm-started (the
        # standard shift); the returned x is x0 + dx
        x = x + x0.astype(dtype)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)
