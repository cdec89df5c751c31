"""Device-resident restarted GMRES(m) for nonsymmetric systems.

Completes the nonsymmetric pair started by ``solvers.bicgstab`` (the
reference is CG-only; see that module's header).  GMRES (Saad & Schultz,
SIAM J. Sci. Stat. Comput. 7, 1986) is the robust long-recurrence option:
monotone residual within a cycle, no breakdown conditions, the standard
choice when BiCGStab's transpose-free recurrence stagnates (e.g. the
``scheme="central"`` convection-diffusion operator past cell-Peclet 2).

Device-first formulation — the design choices that differ from a CPU GMRES:

- The Krylov basis is ONE ``(m+1, n)`` array.  Orthogonalisation is
  classical Gram-Schmidt *done twice* (CGS2, Giraud et al., Num. Math. 101,
  2005): each pass is a pair of dense matmuls (``V @ w`` then ``h @ V``)
  masked to the filled rows — O(1) launches, instead of MGS's
  j sequential dot+axpy round-trips.  CGS2's orthogonality loss is
  O(eps) like MGS, unconditionally — it exists precisely to make
  block/matmul orthogonalisation safe.
- The whole restart cycle (Arnoldi + Givens rotations + the triangular
  solve + the correction) is one jitted program; the restart driver is a
  ``lax.while_loop`` over cycles.  Scalars never visit the host.
- Static shapes everywhere: the cycle always runs ``m`` Arnoldi steps, but
  steps after convergence are FROZEN (masked no-ops, the same pattern as
  ``cg_solve_traced``); the triangular solve neutralises frozen columns by
  zeroing their ``g`` entries against the identity diagonal they kept.
- Right preconditioning with a LINEAR ``M``: the correction applies ``M``
  once to the assembled update (``x += M(V[:m]^T y)``) instead of storing a
  second ``(m, n)`` basis Z as flexible-GMRES would — halves the memory at
  the cost of requiring ``M`` be linear (every M in this framework is).

Residual monitoring inside a cycle uses the Givens-rotation estimate
``|g[j+1]|`` (= the true l2 residual in exact arithmetic, free); the
``converged`` flag and the returned residual are evaluated from the TRUE
residual ``b - A x`` at cycle boundaries in the policy's norm, so
``linf``/``rel_l2`` conventions and fp drift cannot produce a false
convergence claim.
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

# basis-sized matmuls run at MATMUL_PRECISION: a reduced-precision fp32
# matmul (TF32 or bf16 passes) degrades CGS2 orthogonalisation and the
# assembled correction (same failure class as solvers.lobpcg).  These are
# (m, n) @ (n,) matvecs — bandwidth-bound, so full precision is free.
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
_matdot_default = lambda V, w: jnp.matmul(V, w, precision=MATMUL_PRECISION)


def gmres_loop(
    op,
    M_flat: Optional[Callable],
    b_flat: jnp.ndarray,
    x: jnp.ndarray,
    policy: ConvergencePolicy,
    m: int,
    dot: Callable,
    matdot: Callable,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
    flexible: bool = False,
) -> CGResult:
    """The restart-cycle recurrence with INJECTED reductions — shared by the
    single-device driver below and the row-sharded solver
    (``parallel.shard_nonsym.sharded_gmres_loop``), which passes psum-fused
    twins.

    ``op``/``M_flat`` act on (this shard's slice of) a flat vector;
    ``dot(u, v)`` is the (global) inner product; ``matdot(V, w)`` the
    (global) ``(m+1, n) @ (n,)`` basis-projection product (the CGS2 Gram
    pass — ONE collective per orthogonalisation pass when sharded);
    ``pmax_abs(r)`` the global ``max|r|`` for the linf convention.

    ``flexible=True`` is FGMRES (Saad, SIAM J. Sci. Comput. 14, 1993): the
    preconditioned vectors ``z_j = M(v_j)`` are kept as a second ``(m, n)``
    basis Z and the correction is assembled from Z directly (``x += Z^T y``)
    instead of re-applying M once at cycle end.  This is the form that
    admits a NONLINEAR / iteration-varying M — an inner Krylov solve, a
    tolerance-adapted V-cycle — which the memory-saving linear-M form
    cannot (it assumes ``M(V^T y) == Z^T y``).  Cost: one extra ``(m, n)``
    array resident per cycle.
    """
    dtype = b_flat.dtype
    n = n_global if n_global is not None else b_flat.size
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))

    nloc = b_flat.size  # = n single-device; the shard slice when distributed
    r = b_flat - op(x)
    rr0 = dot(r, r)

    def res_of(r):
        if policy.norm == "linf" and pmax_abs is not None:
            return pmax_abs(r)
        return residual_norm(r, dot(r, r), rr0, policy.norm)

    # inner cycles monitor |g[j+1]| — an l2 estimate; translate the policy
    # tolerance into that scale (l2 >= linf makes "linf" conservative: the
    # cycle never stops before the true criterion can hold)
    if policy.norm == "rel_l2":
        inner_tol = tol * jnp.sqrt(rr0)
    else:
        inner_tol = tol

    rows = jnp.arange(m + 1)

    def cycle(x, it_total):
        """One GMRES(m) restart cycle from the current iterate."""
        r = b_flat - op(x)
        beta = jnp.sqrt(dot(r, r))
        V = jnp.zeros((m + 1, nloc), dtype).at[0].set(_safe_div(1.0, beta) * r)
        # FGMRES: the preconditioned basis Z (z_j = M(v_j)), stored so the
        # correction can be taken from it; a zero-row stub otherwise (XLA
        # dead-code-eliminates the untouched carry in the linear-M form).
        # Derived from V rather than jnp.zeros so the carry keeps V's
        # varying-manual-axes type under shard_map (a fresh zeros array is
        # "unvarying" and the while-carry types would mismatch).
        Z = V[1:] * 0 if flexible else V[:0]
        R = jnp.eye(m, dtype=dtype)  # rotated Hessenberg (frozen cols keep e_j)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        cs = jnp.ones(m, dtype)
        sn = jnp.zeros(m, dtype)

        def arnoldi(j, carry):
            V, Z, R, g, cs, sn, k = carry
            it = it_total + k
            active = jnp.logical_and(
                jnp.logical_or(it < min_iter, jnp.abs(g[k]) >= inner_tol),
                it < max_iter,
            )
            vj = jax.lax.dynamic_index_in_dim(V, k, keepdims=False)
            z = vj if M_flat is None else M_flat(vj)
            if flexible:
                Z = jnp.where(active, Z.at[k].set(z), Z)
            w = op(z)
            # CGS2: two matmul orthogonalisation passes against rows <= k
            # (matdot is the global projection — one collective per pass
            # when sharded; the h @ V reconstruction is purely local)
            mask = (rows <= k).astype(dtype)
            h1 = mask * matdot(V, w)
            w = w - jnp.matmul(h1, V, precision=MATMUL_PRECISION)
            h2 = mask * matdot(V, w)
            w = w - jnp.matmul(h2, V, precision=MATMUL_PRECISION)
            h = h1 + h2
            wnorm = jnp.sqrt(dot(w, w))
            V = jnp.where(
                active,
                V.at[k + 1].set(_safe_div(1.0, wnorm) * w),
                V,
            )

            # apply the accumulated Givens rotations to the new column
            def rot(i, hcol):
                hi = hcol[i]
                hi1 = hcol[i + 1]
                use = i < k
                new_hi = jnp.where(use, cs[i] * hi + sn[i] * hi1, hi)
                new_hi1 = jnp.where(use, -sn[i] * hi + cs[i] * hi1, hi1)
                return hcol.at[i].set(new_hi).at[i + 1].set(new_hi1)

            h = jax.lax.fori_loop(0, m, rot, h.at[k + 1].set(wnorm))
            hk = h[k]
            hk1 = h[k + 1]
            denom = jnp.sqrt(hk * hk + hk1 * hk1)
            ck = jnp.where(denom > 0, _safe_div(hk, denom), 1.0)
            sk = _safe_div(hk1, denom)
            cs = jnp.where(active, cs.at[k].set(ck), cs)
            sn = jnp.where(active, sn.at[k].set(sk), sn)
            # denom == 0 (complete breakdown: a zero-residual start forced
            # active by min_iteration) would write a ZERO diagonal into R
            # and NaN the triangular solve; park a 1 there instead — g's
            # matching entry is 0 in exactly that case, so y_k = 0
            col = (h.at[k].set(jnp.where(denom > 0, denom, 1.0)))[:m] * (
                rows[:m] <= k
            ).astype(dtype)
            R = jnp.where(active, R.at[:, k].set(col), R)
            g = jnp.where(
                active,
                g.at[k + 1].set(-sk * g[k]).at[k].set(ck * g[k]),
                g,
            )
            k = k + active.astype(jnp.int32)
            return V, Z, R, g, cs, sn, k

        V, Z, R, g, cs, sn, k = jax.lax.fori_loop(
            0, m, arnoldi, (V, Z, R, g, cs, sn, jnp.int32(0))
        )
        # neutralise frozen columns (identity diagonal + zero rhs -> y = 0)
        g_solve = jnp.where(jnp.arange(m) < k, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(R, g_solve, lower=False)
        if flexible:
            x = x + jnp.matmul(y, Z, precision=MATMUL_PRECISION)
        else:
            u = jnp.matmul(y, V[:m], precision=MATMUL_PRECISION)
            x = x + (u if M_flat is None else M_flat(u))
        return x, it_total + k

    def cond(state):
        x, it, res = state
        unconverged = jnp.logical_or(it < min_iter, res >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    def body(state):
        x, it, _res = state
        x, it = cycle(x, it)
        return x, it, res_of(b_flat - op(x))

    x, it, res = jax.lax.while_loop(cond, body, (x, jnp.int32(0), res_of(r)))
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def gmres_loop_traced(
    op,
    M_flat: Optional[Callable],
    b_flat: jnp.ndarray,
    x: jnp.ndarray,
    policy: ConvergencePolicy,
    m: int,
    dot: Callable,
    matdot: Callable,
    num_cycles: int = 32,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
):
    """Fixed-cycle GMRES recording the true residual after every restart
    cycle (resolution: ``m`` inner iterations per record — within a cycle
    the Givens estimate is monotone by construction, so the cycle-boundary
    record is the informative granularity).  Frozen cycles after
    convergence keep the trailing history flat, like ``cg_solve_traced``.

    Returns ``(CGResult, (num_cycles,) residual_history,
    (num_cycles,) cumulative_iteration_counts)`` — history entries are in
    the POLICY's norm convention.
    """
    dtype = b_flat.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)

    # anchor rel_l2 to the INITIAL residual: inner single-cycle runs use an
    # equivalent ABSOLUTE policy (their own rr0 would re-normalise per cycle)
    r0 = b_flat - op(x)
    rr0 = dot(r0, r0)
    if policy.norm == "rel_l2":
        inner_norm, scale = "l2", jnp.sqrt(rr0)
    else:
        inner_norm, scale = policy.norm, jnp.asarray(1.0, dtype)
    tol_inner = tol * scale

    def step(carry, _):
        x, it, res_abs, done = carry
        # tol=1e-300 underflows to 0 in any device dtype: the inner cycle
        # always runs its full m steps (fixed-work tracing; the policy
        # object itself requires a positive python float)
        r = gmres_loop(
            op, M_flat, b_flat, x,
            ConvergencePolicy(tol=1e-300, norm=inner_norm, max_iteration=int(m)),
            m, dot=dot, matdot=matdot, pmax_abs=pmax_abs, n_global=n_global,
        )
        x2 = jnp.where(done, x, r.x)
        it2 = jnp.where(done, it, it + r.iterations)
        res2 = jnp.where(done, res_abs, r.residual)
        done2 = jnp.logical_or(
            done, jnp.logical_and(res2 < tol_inner, it2 >= min_iter)
        )
        return (x2, it2, res2, done2), (res2 / scale, it2)

    from conjugategradient_tpu.ops.blas import residual_norm as _rn

    if policy.norm == "linf" and pmax_abs is not None:
        res_init = pmax_abs(r0)
    else:
        res_init = _rn(r0, rr0, rr0, inner_norm)
    (x, it, res_abs, done), (hist, its) = jax.lax.scan(
        step, (x, jnp.int32(0), res_init, jnp.asarray(False)), None,
        length=num_cycles,
    )
    res = res_abs / scale
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return (
        CGResult(x=x, iterations=it, residual=res, converged=converged),
        hist,
        its,
    )


def gmres_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b (A square, possibly nonsymmetric) by right-
    preconditioned GMRES(restart), fully on device.

    ``M``: linear preconditioner application (callable or ``(fn, state)``
    pair).  Returns a ``CGResult`` (``iterations`` counts inner Arnoldi
    steps across all cycles).  Shape-agnostic: grid-shaped ``b`` is handled
    (the basis is kept flat internally; ``x`` comes back in ``b``'s shape).
    """
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    op0 = as_operator(A)
    shape = b.shape
    dtype = b.dtype
    b_flat = b.reshape(-1)
    op = (lambda u: op0(u.reshape(shape)).reshape(-1)) if len(shape) > 1 else op0
    M_flat = None
    if M is not None:
        M_flat = (
            (lambda u: _apply_M(M, u.reshape(shape)).reshape(-1))
            if len(shape) > 1
            else (lambda u: _apply_M(M, u))
        )
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    x = jnp.zeros_like(b_flat) if x0 is None else x0.astype(dtype).reshape(-1)
    res = gmres_loop(
        op, M_flat, b_flat, x, policy, m, dot=dot, matdot=_matdot_default
    )
    import dataclasses

    return dataclasses.replace(res, x=res.x.reshape(shape))


def fgmres_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b by FLEXIBLE restarted GMRES (FGMRES, Saad 1993).

    Identical to ``gmres_solve`` except that ``M`` may be ANY callable —
    nonlinear or iteration-varying — because the preconditioned vectors are
    stored as a second (restart, n) basis (see ``gmres_loop(flexible=)``).
    The canonical use is an inner Krylov solve as the preconditioner
    (``inner_solve_preconditioner`` below): inner/outer Krylov composition,
    a capability class the linear-M ``gmres_solve`` excludes by design.
    With a linear ``M`` the two produce the same iterate sequence (tested);
    prefer ``gmres_solve`` there — it holds one less (restart, n) array.
    """
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    op0 = as_operator(A)
    shape = b.shape
    dtype = b.dtype
    b_flat = b.reshape(-1)
    op = (lambda u: op0(u.reshape(shape)).reshape(-1)) if len(shape) > 1 else op0
    M_flat = None
    if M is not None:
        M_flat = (
            (lambda u: _apply_M(M, u.reshape(shape)).reshape(-1))
            if len(shape) > 1
            else (lambda u: _apply_M(M, u))
        )
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    x = jnp.zeros_like(b_flat) if x0 is None else x0.astype(dtype).reshape(-1)
    res = gmres_loop(
        op, M_flat, b_flat, x, policy, m,
        dot=dot, matdot=_matdot_default, flexible=True,
    )
    import dataclasses

    return dataclasses.replace(res, x=res.x.reshape(shape))


def inner_solve_preconditioner(
    A,
    method: str = "bicgstab",
    iterations: int = 8,
    M: Optional[Callable] = None,
    bounds=None,
):
    """A fixed-budget inner Krylov solve of ``A z = v`` packaged as a
    preconditioner callable for ``fgmres_solve`` (inner-outer Krylov).

    The inner solve runs at most ``iterations`` steps of ``method``
    ("bicgstab" | "cg" | "chebyshev") from a zero guess at an effectively
    unreachable tolerance — a *fixed work budget*, not a convergence
    criterion, which is what makes the map nonlinear and FGMRES (not
    GMRES) the required outer method.  ``M`` optionally preconditions the
    inner solve itself (e.g. the multigrid V-cycle), ``bounds=(lo, hi)``
    feeds the Chebyshev inner (estimated via Lanczos when omitted).
    """
    pol = ConvergencePolicy(tol=1e-30, norm="l2", max_iteration=int(iterations))
    if method == "bicgstab":
        from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve

        return lambda v: bicgstab_solve(
            A, v, policy=pol, M=M
        ).x
    if method == "cg":
        from conjugategradient_tpu.solvers.cg import cg_solve

        return lambda v: cg_solve(A, v, policy=pol, M=M).x
    if method == "chebyshev":
        from conjugategradient_tpu.solvers.cheby import chebyshev_solve, estimate_bounds

        if M is not None:
            raise ValueError(
                "inner method 'chebyshev' takes no M (the Chebyshev "
                "iteration has no preconditioner slot — fold scaling into "
                "the operator, or use inner='cg'/'bicgstab' for a "
                "V-cycle-preconditioned inner solve)"
            )
        if bounds is None:
            bounds = estimate_bounds(A)
        lo, hi = bounds
        return lambda v: chebyshev_solve(
            A, v, policy=pol, bounds=(float(lo), float(hi)),
            check_every=int(iterations),
        ).x
    raise ValueError(f"unknown inner method {method!r}; want bicgstab|cg|chebyshev")


def gmres_solve_traced(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    num_cycles: int = 32,
    precise_dot: bool = False,
):
    """Fixed-cycle GMRES recording the residual after every restart cycle
    (the GMRES member of the ``cg_solve_traced`` / ``bicgstab_solve_traced``
    observability family; resolution = one record per ``restart`` inner
    iterations, frozen after convergence).

    Returns ``(CGResult, residual_history, cumulative_iterations)`` —
    both ``(num_cycles,)`` arrays.
    """
    m = int(restart)
    dtype = b.dtype
    b_flat = b.reshape(-1)
    op0 = as_operator(A)
    op = (lambda u: op0(u.reshape(b.shape)).reshape(-1)) if b.ndim > 1 else op0
    M_flat = None if M is None else (lambda u: _apply_M(M, u))
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    x = jnp.zeros_like(b_flat) if x0 is None else x0.astype(dtype).reshape(-1)
    res, hist, its = gmres_loop_traced(
        op, M_flat, b_flat, x, policy, m, dot=dot,
        matdot=_matdot_default, num_cycles=num_cycles,
    )
    import dataclasses

    return dataclasses.replace(res, x=res.x.reshape(b.shape)), hist, its
