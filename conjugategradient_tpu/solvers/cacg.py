"""s-step (communication-avoiding) CG: one reduction per s iterations.

The communication axis so far: cg (2 allreduces/it) -> cg1 (1/it,
Chronopoulos-Gear) -> chebyshev (1 per check_every its, but needs spectral
bounds).  CA-CG (Van Rosendale 1983; Chronopoulos & Gear 1989; Hoemmen
2010; Carson & Demmel 2014) completes it: CG's own optimality — no bounds
required — at TWO reductions per s iterations (the fused Gram, plus one
true-residual norm at the block boundary — see the residual-replacement
note in ``cacg_loop``; without it fp32 at s>=6 MEASURABLY claims false
convergence).

How: per outer step, build the 2s+1-column Krylov basis

    V = [p, Ap, ..., A^s p,  r, Ar, ..., A^{s-1} r]

(2s-1 SpMVs), form the Gram matrix G = V^T V with ONE (m, n) @ (n, m)
matmul — one psum when sharded — then run s standard CG steps
entirely in the m = 2s+1-dimensional COORDINATE space: every inner dot is
a G-weighted (m,) contraction and A's action is the exact shift matrix B
(A V e_j = V e_{j+1} within the basis — the inner recurrence touches
p-degrees <= s and r-degrees <= s-1, so the missing A^{s+1} p column is
never referenced).  After s steps the iterates are materialised with one
(n, m) @ (m,) matmul each and the basis is rebuilt.

In exact arithmetic the iterates EQUAL plain CG's at every step (tested
differentially).  Cost model, stated honestly: the basis costs 2s-1 SpMVs
per s iterations (~2x plain CG's matrix work) — CA-CG buys latency, not
flops; it wins where the allreduce dominates (small shards, multi-host
wires), loses where SpMV dominates.  Numerics: the monomial basis
conditions like kappa^s — keep s <= 4 in fp32 (default; s=6 converges
honestly but slower, s=8's basis is too ill-conditioned to progress and the
solver reports converged=False rather than lying — measured on 63^2
Poisson).  The Gram and materialisation matmuls run at ``MATMUL_PRECISION``
(a reduced-precision fp32 matmul — TF32 or bf16 passes — is fatal to G;
same class as solvers.lobpcg).

Reference parity note: the reference's multi-GPU CG places one scalar
allreduce per dot (`Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:
469-520`); this module is the communication-avoiding answer to that wire
cost taken to its limit.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy

from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def _shift_matrix(s: int, dtype) -> jnp.ndarray:
    """B with A V e_j = V e_{j+1} inside each sub-basis (p-part columns
    0..s-1 -> 1..s, r-part columns s+1..2s-1 -> s+2..2s; the two final
    columns map to 0 and are provably never referenced)."""
    m = 2 * s + 1
    B = jnp.zeros((m, m), dtype)
    for j in range(s):
        B = B.at[j + 1, j].set(1.0)
    for j in range(s + 1, 2 * s):
        B = B.at[j + 1, j].set(1.0)
    return B


def cacg_loop(
    op,
    b,
    x0,
    policy: ConvergencePolicy,
    s: int,
    dot: Callable,
    gram: Callable,
    n_global: Optional[int] = None,
    basis: Optional[Callable] = None,
) -> CGResult:
    """The s-step recurrence with INJECTED reductions (``dot(u, v)`` global
    scalar product, ``gram(V) -> V V^T`` global (m, m) Gram — ONE collective
    per outer step when sharded).  ``op``/vectors may be grid-shaped; the
    basis flattens internally.

    ``basis``: optional override ``(p, r) -> (2s+1, nloc)`` replacing the
    default 2s-1 op() applications — the MATRIX-POWERS KERNEL hook
    (``parallel.halo.dia_basis_powers``: one fused widened halo exchange
    per outer step instead of one per SpMV).
    """
    dtype = b.dtype
    shape = b.shape
    nloc = b.size
    n = n_global if n_global is not None else nloc
    m = 2 * s + 1
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    B = _shift_matrix(s, dtype)

    x = x0
    r = b - op(x)
    rr0 = dot(r, r)
    if policy.norm == "rel_l2":
        tol_sq = tol * tol * rr0
    elif policy.norm == "l2":
        tol_sq = tol * tol
    else:
        raise ValueError(
            "cacg monitors ||r||_2 through the Gram matrix; linf has no "
            "coordinate-space form — use norm='l2' or 'rel_l2'"
        )

    if basis is not None:
        build_basis = basis
    else:
        def build_basis(p, r):
            """(m, nloc) rows [p, Ap, ..., A^s p, r, Ar, ..., A^{s-1} r]."""
            def powers(v, k):
                def step(carry, _):
                    nxt = op(carry)
                    return nxt, nxt.reshape(-1)
                _, rows = jax.lax.scan(step, v, None, length=k)
                return rows
            p_rows = jnp.concatenate([p.reshape(1, -1), powers(p, s)], axis=0)
            r_rows = jnp.concatenate([r.reshape(1, -1), powers(r, s - 1)], axis=0)
            return jnp.concatenate([p_rows, r_rows], axis=0)

    e_p = jnp.zeros(m, dtype).at[0].set(1.0)
    e_r = jnp.zeros(m, dtype).at[s + 1].set(1.0)

    def outer(state):
        x, r, p, rr, it = state
        V = build_basis(p, r)
        G = gram(V)  # ONE collective when sharded

        def inner(j, carry):
            xc, rc, pc, rr_c, it_c = carry
            # rr > 0 guard: a zero residual (b = 0, or an exact warm
            # start) makes tol_sq = 0 under rel_l2 and `rr >= tol_sq` would
            # spin the full budget — measured: 225 its + NaN residual where
            # cg exits at 0 (cg's NaN-res comparison is False; match it)
            active = jnp.logical_and(
                jnp.logical_or(
                    it_c < min_iter,
                    jnp.logical_and(rr_c >= tol_sq, rr_c > 0),
                ),
                it_c < max_iter,
            )
            w = jnp.matmul(B, pc, precision=MATMUL_PRECISION)
            Gw = jnp.matmul(G, w, precision=MATMUL_PRECISION)
            alpha = _safe_div(rr_c, jnp.vdot(pc, Gw, precision=MATMUL_PRECISION))
            xc2 = xc + alpha * pc
            rc2 = rc - alpha * w
            rr2 = jnp.vdot(rc2, jnp.matmul(G, rc2, precision=MATMUL_PRECISION))
            # clamp: coordinate-space rounding can push rr epsilon-negative
            rr2 = jnp.maximum(rr2, 0.0)
            beta = _safe_div(rr2, rr_c)
            pc2 = rc2 + beta * pc
            xc = jnp.where(active, xc2, xc)
            rc = jnp.where(active, rc2, rc)
            pc = jnp.where(active, pc2, pc)
            rr_c = jnp.where(active, rr2, rr_c)
            it_c = it_c + active.astype(jnp.int32)
            return xc, rc, pc, rr_c, it_c

        # inner coordinates: x' = 0 (the s-step CORRECTION), r' = e_r (the
        # residual IS basis column s+1), p' = e_p (column 0)
        xc, rc, pc, rr2, it2 = jax.lax.fori_loop(
            0, s, inner, (jnp.zeros(m, dtype), e_r, e_p, rr, it)
        )
        # materialise (two (m,) @ (m, n) matmuls, purely local)
        x = x + jnp.matmul(xc, V, precision=MATMUL_PRECISION).reshape(shape)
        p = jnp.matmul(pc, V, precision=MATMUL_PRECISION).reshape(shape)
        # RESIDUAL REPLACEMENT at the block boundary: the monomial basis
        # conditions like kappa^s, and the coordinate-space rr drifts —
        # MEASURED at s=6 fp32 on 63^2 Poisson: rr collapses and the solver
        # claims convergence at 6 iterations with TRUE relative residual
        # ~1e-2.  Recomputing r = b - A x (one extra SpMV + one reduction
        # per s-step block) makes every convergence claim honest and stops
        # drift compounding across blocks; total cost stays 2 reductions
        # per s iterations.
        r = b - op(x)
        rr_true = dot(r, r)
        return x, r, p, rr_true, it2

    def cond(state):
        _x, _r, _p, rr, it = state
        unconverged = jnp.logical_or(
            it < min_iter, jnp.logical_and(rr >= tol_sq, rr > 0)
        )
        return jnp.logical_and(unconverged, it < max_iter)

    state = (x, r, r, rr0, jnp.int32(0))  # p_0 = r_0 seeds the first basis
    x, r, p, rr, it = jax.lax.while_loop(cond, outer, state)
    res = jnp.sqrt(rr / rr0) if policy.norm == "rel_l2" else jnp.sqrt(rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def cacg_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    s: int = 4,
) -> CGResult:
    """Solve SPD ``A x = b`` by s-step CG, fully on device.

    Iterate-for-iterate equal to ``cg_solve`` in exact arithmetic (tested);
    worth it when reductions dominate (distributed, latency-bound) — the
    single-device form exists for validation and for callers who want the
    Gram-fused reduction structure (e.g. under vmap).  No preconditioner:
    fold symmetric diagonal scaling into ``A`` at setup for the Jacobi
    effect (a general M breaks the shift-matrix identity; preconditioned
    CA-CG needs an M-basis — out of scope, use cg/cg1 there).
    """
    if int(s) < 1:
        raise ValueError("s must be >= 1")
    op = as_operator(A)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(b.dtype)
    dot = lambda u, v: jnp.vdot(u, v, precision=MATMUL_PRECISION, preferred_element_type=u.dtype)
    gram = lambda V: jnp.matmul(V, V.T, precision=MATMUL_PRECISION)
    return cacg_loop(op, b, x, policy, int(s), dot=dot, gram=gram)
