"""IDR(s): induced dimension reduction for nonsymmetric systems.

Fills the gap between the framework's two nonsymmetric workhorses:
BiCGStab (constant memory, but a product-type recurrence that can stagnate
on strongly nonsymmetric/indefinite operators) and restarted GMRES (optimal
per cycle, but O(restart · n) memory and restart-induced stalls).  IDR(s)
(Sonneveld & van Gijzen, SIAM J. Sci. Comput. 31(2), 2008; the
biorthogonalized "elegant" variant of van Gijzen & Sonneveld, ACM TOMS
38(1), 2011) forces the residual into a shrinking sequence of Sonneveld
subspaces: finite termination in at most n + n/s matvecs in exact
arithmetic, GMRES-like robustness as ``s`` grows, at fixed O(s·n) memory.
``s=4`` is the standard sweet spot; ``s=1`` is mathematically BiCGStab.

Device shape: the shadow-space products ``P^T r`` / ``P^T g`` are (s, n) @ (n,)
matmuls (``MATMUL_PRECISION`` — the repo-wide rule for reductions feeding
direction logic); the inner k-loop over the s dimension-reduction steps is
statically unrolled (s is small and static), every small triangular solve is
an (s-k)×(s-k) static-shape ``jax.scipy.linalg.solve_triangular``, and the
outer cycle is one ``lax.while_loop`` — zero host crossings, like every
solver here.

Right preconditioning (``M``): applied at the two auxiliary-vector sites
(the standard preconditioned form — the recurrence then runs on A M with
solution updates through M, so the monitored residual stays the TRUE
residual of A x = b).  ``M`` must be linear.

Iteration accounting: ``iterations`` counts MATVECS (s+1 per cycle), the
comparable unit against bicgstab (2/iteration) and gmres (1/iteration).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.blas import residual_norm
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, _apply_M, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy

from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def idr_loop(
    op,
    M,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray],
    policy: ConvergencePolicy,
    s: int = 4,
    seed: int = 0,
    angle: float = 0.7,
    dot=None,
    matdot=None,
    pmax_abs=None,
    n_global: Optional[int] = None,
    shadow_key_shape: Optional[tuple] = None,
    trace_cycles: Optional[int] = None,
    replace_every: int = 8,
) -> CGResult:
    """The IDR(s) recurrence with injectable reductions — the sharded form
    passes psum-wrapped ``dot``/``matdot``/``pmax_abs`` and a shard-local
    ``op`` (the ``gmres_loop`` convention).  ``shadow_key_shape`` fixes the
    GLOBAL shadow-vector shape so every shard draws the same random P and
    slices its own rows (sharded determinism).

    ``replace_every``: RELIABLE-UPDATE residual replacement — every that
    many cycles the recurrence residual is recomputed as ``b - A x`` (one
    extra matvec, ~1/(replace_every*(s+1)) overhead; 0 disables).  Without
    it the fp32 recurrence drifts catastrophically from the true residual
    on long solves: measured on 255^2 convection-diffusion eps=0.5 fp32,
    the un-replaced recurrence reported rel 2.0e-6 "converged" while the
    TRUE relative residual was 1.4e-2 (a 7000x lie, ~1400 cycles of
    accumulated drift); with replacement the flag is honest.  The same
    medicine as ``solvers.cacg``'s block-boundary replacement.  The
    replacement predicate is replicated across shards, so the conditional
    matvec (with its collectives) is SPMD-uniform — legal under shard_map.

    ``trace_cycles``: run a FIXED-length ``lax.scan`` of that many cycles
    instead of the while_loop (converged cycles freeze — the
    ``bicgstab_solve_traced`` convention) and return
    ``(CGResult, residual_history)`` with one entry per CYCLE (= s+1
    matvecs); entries past convergence repeat the final residual.
    """
    n = b.size if n_global is None else n_global
    dtype = b.dtype
    shape = b.shape
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v, precision=MATMUL_PRECISION, preferred_element_type=dtype)
    if pmax_abs is None:
        pmax_abs = lambda r: jnp.max(jnp.abs(r))

    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    r = b - op(x)
    rr0 = dot(r, r)

    # shadow space: s column-normalized random vectors, rows of Pt (s, n) —
    # the (s, n) @ (n,) products are one matmul each.  Column normalization
    # (not QR): IDR's theory needs only a full-rank random P, random
    # Gaussian columns are near-orthogonal at scale anyway, and dropping
    # the QR removes an O(n s^2) replicated factorization from the sharded
    # setup (review finding).  Sharded callers draw the same global matrix
    # everywhere and keep their own row block (an O(n_global s) TRANSIENT
    # per shard at trace time — RNG only, no factorization; exact matvec
    # parity with single-device in exchange).
    key = jax.random.PRNGKey(seed)
    if shadow_key_shape is None:
        Pm = jax.random.normal(key, (b.size, s), dtype)
        Pt = (Pm / jnp.linalg.norm(Pm, axis=0, keepdims=True)).T  # (s, n)
    else:
        ng = int(np.prod(shadow_key_shape))
        Pm = jax.random.normal(key, (ng, s), dtype)
        Pm = Pm / jnp.linalg.norm(Pm, axis=0, keepdims=True)
        i = jax.lax.axis_index(_shard_axis_of(matdot))
        Pt = jax.lax.dynamic_slice_in_dim(Pm.T, i * b.size, b.size, axis=1)

    if matdot is None:
        pdot = lambda v: jnp.matmul(Pt, v.reshape(-1), precision=MATMUL_PRECISION)  # (s,)
    else:
        pdot = lambda v: matdot(Pt, v.reshape(-1))

    # stacked from zeros_like(b) so the blocks inherit b's sharding/varying
    # axes under shard_map (a bare jnp.zeros would be replicated-constant
    # and fail the while_loop carry-type check)
    G = jnp.stack([jnp.zeros_like(b)] * s)  # (s, *shape)
    U = jnp.stack([jnp.zeros_like(b)] * s)
    Ms = jnp.eye(s, dtype=dtype)  # M[i, j] = p_i^T g_j, lower triangular
    om = jnp.asarray(1.0, dtype)

    def res_of(r):
        if policy.norm == "linf":
            return pmax_abs(r)
        rr = dot(r, r)
        return residual_norm(r, rr, rr0, policy.norm)

    def cond(state):
        x, r, U, G, Ms, om, it = state
        unconverged = jnp.logical_or(it < min_iter, res_of(r) >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    def body(state):
        x, r, U, G, Ms, om, it = state
        f = pdot(r)
        # s dimension-reduction steps (statically unrolled over k)
        for k in range(s):
            # c solves the trailing lower-triangular block M[k:, k:] c = f[k:]
            c = jax.scipy.linalg.solve_triangular(
                Ms[k:, k:], f[k:], lower=True
            )
            # full precision: these combines feed the shadow Gram and the
            # triangular solves (the repo-wide MATMUL_PRECISION rule)
            v = r - jnp.tensordot(c, G[k:], axes=1, precision=MATMUL_PRECISION)
            v_hat = _apply_M(M, v)
            u_k = jnp.tensordot(c, U[k:], axes=1, precision=MATMUL_PRECISION) + om * v_hat
            g_k = op(u_k)
            # biorthogonalize g_k against the already-updated p_0..p_{k-1}
            # (single-row shadow dots — a full pdot here would waste an
            # (s, n) matmul per inner index, review finding)
            for i in range(k):
                alpha = _safe_div(dot(Pt[i], g_k.reshape(-1)), Ms[i, i])
                g_k = g_k - alpha * G[i]
                u_k = u_k - alpha * U[i]
            U = U.at[k].set(u_k)
            G = G.at[k].set(g_k)
            mcol = pdot(g_k)  # p_i^T g_k for all i; rows < k are ~0
            Ms = Ms.at[:, k].set(mcol)
            beta = _safe_div(f[k], mcol[k])
            r = r - beta * g_k
            x = x + beta * u_k
            if k + 1 < s:
                f = f - beta * mcol
                # entries 0..k are exact zeros in exact arithmetic; force
                # them so rounding noise cannot leak into later solves
                f = jnp.where(jnp.arange(s) <= k, 0.0, f)
        # enter the next Sonneveld space G_{j+1}
        v_hat = _apply_M(M, r)
        t = op(v_hat)
        tt = dot(t, t)
        tr = dot(t, r)
        om_new = _safe_div(tr, tt)
        # omega maintenance (Sleijpen/van der Vorst kappa-angle rule)
        nt = jnp.sqrt(tt)
        nr = jnp.sqrt(dot(r, r))
        rho = jnp.abs(_safe_div(tr, nt * nr))
        om_new = jnp.where(
            rho < angle, om_new * _safe_div(jnp.asarray(angle, dtype), rho),
            om_new,
        )
        r = r - om_new * t
        x = x + om_new * v_hat
        it_new = it + jnp.int32(s + 1)
        if replace_every:
            # reliable update (see docstring): recompute r = b - A x every
            # replace_every cycles; lax.cond executes the matvec only on
            # those cycles (replicated predicate -> SPMD-uniform branch)
            cyc = it_new // jnp.int32(s + 1)
            r = jax.lax.cond(
                cyc % jnp.int32(replace_every) == 0,
                lambda xr: b - op(xr[0]),
                lambda xr: xr[1],
                (x, r),
            )
        return (x, r, U, G, Ms, om_new, it_new)

    state = (x, r, U, G, Ms, om, jnp.int32(0))
    if trace_cycles is None:
        x, r, U, G, Ms, om, it = jax.lax.while_loop(cond, body, state)
        res = res_of(r)
        converged = jnp.logical_and(res < tol, it >= min_iter)
        return CGResult(x=x, iterations=it, residual=res, converged=converged)

    def scan_step(st, _):
        active = cond(st)
        new = body(st)
        st = jax.tree.map(lambda a, b_: jnp.where(active, b_, a), st, new)
        return st, res_of(st[1])

    state, hist = jax.lax.scan(scan_step, state, None, length=int(trace_cycles))
    x, r, U, G, Ms, om, it = state
    res = res_of(r)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged), hist


def _shard_axis_of(matdot):
    """The sharded caller smuggles its mesh axis on the injected matdot
    (see ``parallel.shard_nonsym.sharded_idr_loop``)."""
    return matdot.shard_axis


def idr_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    s: int = 4,
    M: Optional[Callable] = None,
    seed: int = 0,
    angle: float = 0.7,
    replace_every: int = 8,
) -> CGResult:
    """Solve A x = b (square, possibly nonsymmetric) by IDR(s).

    ``s``: shadow-space dimension (static; memory is 2(s+1) n-vectors).
    ``angle``: the omega maintenance safeguard of Sleijpen & van der Vorst
    (kappa = 0.7): when the t/r angle cosine falls below it, omega is
    lengthened — measured to prevent the stagnation plateaus of the pure
    minimal-residual omega.  Returns a ``CGResult`` (``iterations`` =
    MATVEC count, s+1 per cycle — the comparable unit vs bicgstab at
    2/iteration; shape-agnostic b like the other solvers).
    """
    return idr_loop(
        as_operator(A), M, b, x0, policy, s=s, seed=seed, angle=angle,
        replace_every=replace_every,
    )


def idr_solve_traced(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    s: int = 4,
    M: Optional[Callable] = None,
    num_cycles: int = 100,
    seed: int = 0,
    angle: float = 0.7,
):
    """Fixed-length IDR(s) recording the residual after every CYCLE (= s+1
    matvecs) — the diagnostics twin of ``bicgstab_solve_traced`` /
    ``cg_solve_traced``.  Returns ``(CGResult, history)``; entries past
    convergence repeat the final residual (truncate at
    ``iterations // (s + 1)``)."""
    return idr_loop(
        as_operator(A), M, b, x0, policy, s=s, seed=seed, angle=angle,
        trace_cycles=num_cycles,
    )
