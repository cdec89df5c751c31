"""Multi-RHS CG: solve A X = B for k right-hand sides in one device program.

Not in the reference (single-RHS throughout) — this is where the SpMM path
(``ops/spmm.py``) earns its keep: one matrix pass serves k Krylov recurrences,
so the per-solve HBM traffic of the dominant operand drops k-fold.  Each
column runs its own scalar recurrence (columnwise alphas/betas); converged
columns freeze (masked updates) until all are done or max_iteration hits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core.formats import (
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    StencilMatrix,
)
from conjugategradient_tpu.solvers.cg import _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class MultiCGResult:
    x: jax.Array  # (n, k)
    iterations: jax.Array  # (k,) int32 per-column iteration counts
    residual: jax.Array  # (k,) final residuals (selected norm)
    converged: jax.Array  # (k,) bool


jax.tree_util.register_dataclass(
    MultiCGResult, data_fields=["x", "iterations", "residual", "converged"], meta_fields=[]
)


def _as_multi_operator(A):
    from conjugategradient_tpu.core.formats import ConstStencilMatrix
    from conjugategradient_tpu.ops.spmm import spmm
    from conjugategradient_tpu.ops.stencil import spmm_const_stencil, spmm_stencil

    if isinstance(A, (StencilMatrix, ConstStencilMatrix)):
        # (n, k) <-> (*grid, k)
        fn = spmm_const_stencil if isinstance(A, ConstStencilMatrix) else spmm_stencil

        def op(P):
            return fn(A, P.reshape(A.grid + (P.shape[-1],))).reshape(A.n, -1)

        return op
    if isinstance(A, (DiaMatrix, CsrMatrix, EllMatrix, CooMatrix, BsrMatrix, DenseMatrix)):
        return lambda P: spmm(A, P)
    return A  # already a multi-RHS callable


def as_multi_preconditioner(h):
    """Multi-RHS V-cycle: M mapping (n, k) -> (n, k) — one cycle per column,
    batched over the trailing axis (``vmap`` turns every stencil SpMV in the
    cycle into the SpMM form of ``ops.spmm.spmm_stencil``: one matrix pass
    serves all k columns, which is the whole point of multi-RHS).  Plug into
    ``cg_solve_multi(..., M=...)`` — the multi-RHS MGCG the single-RHS path
    gets from ``precond.as_preconditioner``."""
    from conjugategradient_tpu.precond.multigrid import v_cycle

    def M(R):  # (n, k) flat columns
        cyc = jax.vmap(lambda r: v_cycle(h, r), in_axes=1, out_axes=1)
        return cyc(R)

    return M


def cg_solve_multi(
    A,
    B: jnp.ndarray,
    X0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M=None,
    psum_axis: Optional[str] = None,
    n_global: Optional[int] = None,
) -> MultiCGResult:
    """Solve A X = B, B of shape (n, k), fully on device.

    Per-column convergence policy (same tol/norm for all columns); the loop
    exits when every column is converged or at max_iteration.  ``M`` is an
    optional (n, k) -> (n, k) preconditioner applied per column (see
    ``as_multi_preconditioner`` for the multigrid one); with it this is
    multi-RHS MGCG — k Krylov recurrences sharing one matrix stream per
    iteration.

    ``psum_axis`` runs the same loop inside ``shard_map``: ``A`` must then be
    a shard-local (n_local, k) operator (with its own halo collectives), and
    every per-column dot becomes ONE (k,)-vector ``psum`` over the mesh axis
    (k scalars per collective — the multi-RHS wire economy).  Pass
    ``n_global`` so the max-iteration policy sees the true system size.  See
    ``parallel.shard_multi.sharded_cg_multi_solve`` for the placed wrapper.
    """
    op = _as_multi_operator(A)
    n, k = B.shape
    dtype = B.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n_global if n_global is not None else n))

    if psum_axis is not None:
        cdot = lambda U, V: jax.lax.psum(jnp.sum(U * V, axis=0), psum_axis)
        cexp = lambda s: s[None, :]
        clinf = lambda R: jax.lax.pmax(jnp.max(jnp.abs(R), axis=0), psum_axis)
        M_work = M
    else:
        cdot = lambda U, V: jnp.sum(U * V, axis=0)
        cexp = lambda s: s[None, :]
        clinf = lambda R: jnp.max(jnp.abs(R), axis=0)
        M_work = M

    X = jnp.zeros_like(B) if X0 is None else X0.astype(dtype)
    R = B - op(X)
    Z = M_work(R) if M_work is not None else R
    P = Z
    rz = cdot(R, Z)
    rr = cdot(R, R)
    rr0 = rr

    def res_of(R, rr):
        if policy.norm == "l2":
            return jnp.sqrt(rr)
        if policy.norm == "linf":
            return clinf(R)
        if policy.norm == "rel_l2":
            return jnp.sqrt(rr / jnp.where(rr0 == 0, 1.0, rr0))
        raise ValueError(policy.norm)

    def active_of(R, rr, it):
        res = res_of(R, rr)
        return jnp.logical_and(
            jnp.logical_or(it < min_iter, res >= tol), it < max_iter
        )

    def cond(state):
        X, R, P, rz, rr, it = state
        return jnp.any(active_of(R, rr, it))

    def body(state):
        X, R, P, rz, rr, it = state
        active = active_of(R, rr, it)  # (k,)
        AP = op(P)
        alpha = jnp.where(active, _safe_div(rz, cdot(P, AP)), 0.0)
        X = X + cexp(alpha) * P
        R2 = R - cexp(alpha) * AP
        Z2 = M_work(R2) if M_work is not None else R2
        rz2 = cdot(R2, Z2)
        rr2 = cdot(R2, R2)
        beta = jnp.where(active, _safe_div(rz2, rz), 0.0)
        P2 = jnp.where(cexp(active), Z2 + cexp(beta) * P, P)
        rz2 = jnp.where(active, rz2, rz)
        rr2 = jnp.where(active, rr2, rr)
        R2 = jnp.where(cexp(active), R2, R)
        return (X, R2, P2, rz2, rr2, it + active.astype(jnp.int32))

    X, R, P, rz, rr, it = jax.lax.while_loop(
        cond, body, (X, R, P, rz, rr, jnp.zeros(k, jnp.int32))
    )
    res = res_of(R, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return MultiCGResult(x=X, iterations=it, residual=res, converged=converged)


def bicgstab_solve_multi(
    A,
    B: jnp.ndarray,
    X0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M=None,
    psum_axis: Optional[str] = None,
    n_global: Optional[int] = None,
) -> MultiCGResult:
    """Multi-RHS BiCGStab: solve A X = B for a NONSYMMETRIC A, B of shape
    (n, k), fully on device — the nonsymmetric twin of ``cg_solve_multi``.

    One SpMM pass serves k BiCGStab recurrences per half-step (two passes
    per iteration, like the single-RHS form's two SpMVs), so the dominant
    matrix traffic is amortised k-fold.  Each column runs its own scalar
    recurrence (columnwise rho/alpha/omega); converged columns freeze via
    masked updates (the exact convention of ``cg_solve_multi``), and the
    per-column ``_safe_div`` keeps breakdowns NaN-free per column rather
    than poisoning the block.

    ``M`` is an optional (n, k) -> (n, k) RIGHT preconditioner (linear;
    ``as_multi_preconditioner`` for the V-cycle — multi-RHS mg_bicgstab).
    ``psum_axis`` runs the loop inside ``shard_map`` with ONE (k,)-vector
    psum per dot, exactly like ``cg_solve_multi``; ``A`` must then be a
    shard-local (n_local, k) operator.

    GMRES has no cheap block twin here (per-column Arnoldi bases do not
    share a matrix pass without a true block method's breakdown handling);
    for multi-RHS GMRES vmap ``gmres_solve`` over columns instead.
    """
    op = _as_multi_operator(A)
    n, k = B.shape
    dtype = B.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n_global if n_global is not None else n))

    if psum_axis is not None:
        cdot = lambda U, V: jax.lax.psum(jnp.sum(U * V, axis=0), psum_axis)
        clinf = lambda R: jax.lax.pmax(jnp.max(jnp.abs(R), axis=0), psum_axis)
    else:
        cdot = lambda U, V: jnp.sum(U * V, axis=0)
        clinf = lambda R: jnp.max(jnp.abs(R), axis=0)
    cexp = lambda s: s[None, :]

    X = jnp.zeros_like(B) if X0 is None else X0.astype(dtype)
    R = B - op(X)
    Rhat = R  # fixed shadow residual per column
    rr0 = cdot(R, R)
    onek = jnp.ones(k, dtype)

    def res_of(R, rr):
        if policy.norm == "l2":
            return jnp.sqrt(rr)
        if policy.norm == "linf":
            return clinf(R)
        if policy.norm == "rel_l2":
            return jnp.sqrt(rr / jnp.where(rr0 == 0, 1.0, rr0))
        raise ValueError(policy.norm)

    def active_of(R, rr, it):
        res = res_of(R, rr)
        return jnp.logical_and(
            jnp.logical_or(it < min_iter, res >= tol), it < max_iter
        )

    def cond(state):
        X, R, Pd, V, rho, alpha, omega, rr, it = state
        return jnp.any(active_of(R, rr, it))

    def body(state):
        X, R, Pd, V, rho, alpha, omega, rr, it = state
        active = active_of(R, rr, it)  # (k,)
        rho_new = cdot(Rhat, R)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        Pd2 = R + cexp(beta) * (Pd - cexp(omega) * V)
        Phat = M(Pd2) if M is not None else Pd2
        V2 = op(Phat)
        alpha2 = _safe_div(rho_new, cdot(Rhat, V2))
        S = R - cexp(alpha2) * V2
        Shat = M(S) if M is not None else S
        T = op(Shat)
        omega2 = _safe_div(cdot(T, S), cdot(T, T))
        X2 = X + cexp(alpha2) * Phat + cexp(omega2) * Shat
        R2 = S - cexp(omega2) * T
        am = cexp(active)
        X = jnp.where(am, X2, X)
        R2 = jnp.where(am, R2, R)
        Pd2 = jnp.where(am, Pd2, Pd)
        V2 = jnp.where(am, V2, V)
        rho2 = jnp.where(active, rho_new, rho)
        alpha2 = jnp.where(active, alpha2, alpha)
        omega2 = jnp.where(active, omega2, omega)
        rr2 = jnp.where(active, cdot(R2, R2), rr)
        return (X, R2, Pd2, V2, rho2, alpha2, omega2, rr2, it + active.astype(jnp.int32))

    zero = jnp.zeros_like(B)
    state = (X, R, zero, zero, onek, onek, onek, rr0, jnp.zeros(k, jnp.int32))
    X, R, Pd, V, rho, alpha, omega, rr, it = jax.lax.while_loop(cond, body, state)
    res = res_of(R, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return MultiCGResult(x=X, iterations=it, residual=res, converged=converged)
