"""Row-block-sharded solvers beyond plain CG: BiCGStab, GMRES(m), MINRES
and the dot-free Chebyshev iteration (all built by psum-injection into the
shared single-device loops).

Extends the flagship distributed design (``parallel.sharded_cg`` — the
re-design of ``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:424-565``)
beyond symmetry: the same one-jitted-SPMD-program architecture (halo
``ppermute`` SpMV, ``psum`` dots, on-device convergence predicate, zero
host crossings) carrying the nonsymmetric recurrences of
``solvers.bicgstab`` / ``solvers.gmres``.

Communication structure (the part worth designing, cf. ``docs/SCALING.md``):

- BiCGStab's textbook form needs FOUR collective dots at three dependency
  points per iteration.  Here they are refactored to TWO wire messages:
  alpha's dot ``(rhat, v)`` stands alone, and the five remaining products —
  ``(t,s), (t,t), (s,s), (rhat,s), (rhat,t)`` — are fused into one
  (5,)-psum, from which omega, the residual norm ``(r,r) = (s,s) - 2w(t,s)
  + w^2 (t,t)`` and the NEXT iteration's rho ``(rhat, r) = (rhat,s) -
  w (rhat,t)`` all follow algebraically (exact-arithmetic identities; the
  same trick as the Chronopoulos–Gear CG variant).
- GMRES is ``solvers.gmres.gmres_loop`` verbatim with psum-injected
  reductions: each CGS2 orthogonalisation pass is ONE (m+1,)-psum (the
  local ``V @ w`` Gram product followed by the collective), the basis V
  lives row-sharded — ``(m+1, n_local)`` per shard, never gathered — and
  the Givens/triangular machinery is replicated scalar work.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.formats import DiaMatrix
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
from conjugategradient_tpu.parallel.halo import (
    spmv_dia_allgather,
    spmv_dia_local_overlap,
)
from conjugategradient_tpu.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu.solvers.gmres import gmres_loop
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def _pdot_fused(pairs, axis):
    parts = jnp.stack(
        [jnp.dot(a.ravel(), b.ravel(), precision=MATMUL_PRECISION,
                 preferred_element_type=a.dtype) for a, b in pairs]
    )
    return jax.lax.psum(parts, axis)


def sharded_bicgstab_loop(
    op, M, b, x0, policy: ConvergencePolicy, axis: str, n_global: int
) -> CGResult:
    """Shard-local BiCGStab recurrence with the 2-collective iteration (see
    module docstring).  Runs inside ``shard_map``; same Krylov sequence as
    ``solvers.bicgstab.bicgstab_solve`` in exact arithmetic."""
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n_global))

    x = x0
    r = b - op(x)
    rhat = r
    (rr0, rho0) = _pdot_fused(((r, r), (rhat, r)), axis)
    one = jnp.asarray(1.0, dtype)
    zerov = jnp.zeros_like(b)

    def res_of(r_local, rr):
        if policy.norm == "linf":
            return jax.lax.pmax(jnp.max(jnp.abs(r_local)), axis)
        if policy.norm == "rel_l2":
            return jnp.sqrt(rr / rr0)
        return jnp.sqrt(rr)

    # rho = (rhat, r) enters each iteration already reduced (produced by the
    # PREVIOUS iteration's fused (5,)-psum, or by the init); rho_prev rides
    # along for the beta ratio
    def body(state):
        x, r, p, v, rho, rho_prev, alpha, omega, rr, it = state
        beta = _safe_div(rho, rho_prev) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = M(p)
        v = op(p_hat)
        alpha = _safe_div(rho, jax.lax.psum(
            jnp.dot(rhat.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                    preferred_element_type=dtype), axis
        ))
        s = r - alpha * v
        s_hat = M(s)
        t = op(s_hat)
        ts, tt, ss, rhs, rht = _pdot_fused(
            ((t, s), (t, t), (s, s), (rhat, s), (rhat, t)), axis
        )
        omega = _safe_div(ts, tt)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        # algebraic identity for (r, r); clamp: rounding can push the
        # difference epsilon-negative exactly at convergence
        rr_new = jnp.maximum(ss - 2.0 * omega * ts + omega * omega * tt, 0.0)
        rho_new = rhs - omega * rht
        return (x, r, p, v, rho_new, rho, alpha, omega, rr_new, it + 1)

    def cond(state):
        _x, r, _p, _v, _rho, _rho_prev, _alpha, _omega, rr, it = state
        unconverged = jnp.logical_or(it < min_iter, res_of(r, rr) >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    state = (x, r, zerov, zerov, rho0, one, one, one, rr0, jnp.int32(0))
    x, r, p, v, rho, rho_prev, alpha, omega, rr, it = jax.lax.while_loop(
        cond, body, state
    )
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def sharded_gmres_loop(
    op, M, b, x0, policy: ConvergencePolicy, axis: str, n_global: int,
    restart: int = 32, flexible: bool = False,
) -> CGResult:
    """``solvers.gmres.gmres_loop`` with psum-injected reductions (see
    module docstring).  ``M=None`` for unpreconditioned.  ``flexible=True``
    is row-sharded FGMRES: the Z basis shards exactly like V
    ((m, n_local) per shard), and — because the correction is assembled
    from Z locally — a shard-local ``M`` may then be NONLINEAR (e.g. a
    fixed-budget inner solve on the shard's diagonal block)."""
    pdot = lambda u, v: jax.lax.psum(
        jnp.dot(u.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                preferred_element_type=u.dtype), axis
    )
    # full precision on the local Gram product — a reduced-precision fp32
    # matmul degrades CGS2 (see solvers.gmres._matdot_default)
    pmatdot = lambda V, w: jax.lax.psum(
        jnp.matmul(V, w, precision=MATMUL_PRECISION), axis
    )
    pmax_abs = lambda r: jax.lax.pmax(jnp.max(jnp.abs(r)), axis)
    return gmres_loop(
        op, M, b, x0, policy, int(restart),
        dot=pdot, matdot=pmatdot, pmax_abs=pmax_abs, n_global=n_global,
        flexible=flexible,
    )


def sharded_idr_loop(
    op, M, b, x0, policy: ConvergencePolicy, axis: str, n_global: int,
    s: int = 4, seed: int = 0, angle: float = 0.7, replace_every: int = 8,
) -> CGResult:
    """``solvers.idr.idr_loop`` with psum-injected reductions: the shadow
    Gram products become one (s,)-psum each, the shadow matrix is drawn
    GLOBALLY (same key on every shard) and row-sliced locally, so the
    sharded trajectory is the single-device one up to reduction order."""
    from conjugategradient_tpu.solvers.idr import idr_loop

    pdot = lambda u, v: jax.lax.psum(
        jnp.vdot(u, v, precision=MATMUL_PRECISION, preferred_element_type=u.dtype), axis
    )

    def matdot(Pt, w):
        return jax.lax.psum(
            jnp.matmul(Pt, w, precision=MATMUL_PRECISION), axis
        )

    matdot.shard_axis = axis
    pmax_abs = lambda r: jax.lax.pmax(jnp.max(jnp.abs(r)), axis)
    return idr_loop(
        op, M, b, x0, policy, s=s, seed=seed, angle=angle, dot=pdot,
        matdot=matdot, pmax_abs=pmax_abs, n_global=n_global,
        shadow_key_shape=(n_global,), replace_every=replace_every,
    )


def sharded_minres_loop(
    op, M, b, x0, policy: ConvergencePolicy, axis: str, n_global: int
) -> CGResult:
    """``solvers.minres.minres_loop`` with psum-injected reductions — the
    distributed symmetric-indefinite solver (two scalar psums per
    iteration: the Lanczos alfa and beta products)."""
    from conjugategradient_tpu.solvers.minres import minres_loop

    pdot = lambda u, v: jax.lax.psum(
        jnp.dot(u.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                preferred_element_type=u.dtype), axis
    )
    pmax_abs = lambda r: jax.lax.pmax(jnp.max(jnp.abs(r)), axis)
    return minres_loop(
        op, M, b, x0, policy, dot=pdot, pmax_abs=pmax_abs, n_global=n_global
    )


def sharded_lsmr_loop(
    op, opT, b, x0, policy: ConvergencePolicy, axis: str, n_global: int,
    damp: float = 0.0,
) -> CGResult:
    """``solvers.lsmr.lsmr_loop`` with a psum-injected 2-norm — the
    distributed least-squares solver.  The norm is the recurrence's ONLY
    reduction (the Golub-Kahan beta and alpha), so each iteration costs two
    scalar psums on top of the two halo SpMVs (A and A^T)."""
    from conjugategradient_tpu.solvers.lsmr import lsmr_loop

    pnorm = lambda v: jnp.sqrt(
        jax.lax.psum(jnp.vdot(v, v, precision=MATMUL_PRECISION,
                              preferred_element_type=v.dtype).real, axis)
    )
    b_eff = b if x0 is None else b - op(x0)
    x, it, res, converged, _ = lsmr_loop(
        op, opT, b_eff, policy, damp=damp, n_iter_scale=n_global, nrm=pnorm
    )
    if x0 is not None:
        x = x + x0
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def sharded_chebyshev_loop(
    op, b, x0, policy: ConvergencePolicy, axis: str, n_global: int,
    lo: float, hi: float, check_every: int = 16
) -> CGResult:
    """Dot-free distributed solve: ONE all-reduce per ``check_every``
    halo-exchange SpMVs (the latency-bound-regime extreme of the
    communication axis — cf. variant="cg1" at 1/iteration)."""
    from conjugategradient_tpu.solvers.cheby import chebyshev_loop

    pdot = lambda u, v: jax.lax.psum(
        jnp.dot(u.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                preferred_element_type=u.dtype), axis
    )
    pmax_abs = lambda r: jax.lax.pmax(jnp.max(jnp.abs(r)), axis)
    return chebyshev_loop(
        op, b, x0, policy, lo, hi, pdot, check_every=check_every,
        pmax_abs=pmax_abs, n_global=n_global,
    )


def sharded_chebyshev_block_loop(
    data, offsets, b, x0, policy: ConvergencePolicy, axis: str, num: int,
    n_global: int, lo: float, hi: float, check_every: int = 16,
) -> CGResult:
    """EXTENDED-REGION Chebyshev: ``check_every`` iterations per halo
    exchange — 2 ``ppermute`` + 1 ``psum`` per block (vs 2 permutes/SpMV +
    1 psum/block for ``sharded_chebyshev_loop``: 33 wire messages down
    to 3 per 16 iterations).

    Same trick as CA-CG's matrix-powers kernel (``halo.dia_basis_powers``):
    the DIA data is pre-extended with the neighbors' H = check*bandwidth
    boundary ROWS once per solve; each block exchanges (r, d) boundary
    slabs in ONE fused ppermute pair and runs the three-term recurrence on
    the (n_local + 2H)-extended vectors — the valid region shrinks by one
    bandwidth per iteration and still covers the center after
    ``check_every`` steps, which is all the carried state keeps.  x stays
    local (its halo is never consumed).  Global-edge wraparound is masked
    by the DIA structural-zero invariant at every step (the matrix-powers
    argument, inductively).  Requires H <= n_local.
    """
    from conjugategradient_tpu.parallel.halo import (
        extend_dia_data,
        spmv_dia_local_overlap,
    )
    from conjugategradient_tpu.ops.blas import residual_norm

    dtype = b.dtype
    n_local = b.shape[0]
    halo = max((abs(o) for o in offsets), default=0)
    check = int(check_every)
    H = check * halo
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n_global))

    theta = jnp.asarray((hi + lo) / 2.0, dtype)
    delta = jnp.asarray((hi - lo) / 2.0, dtype)
    sigma = theta / delta

    pdot = lambda u, v: jax.lax.psum(
        jnp.dot(u.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                preferred_element_type=u.dtype), axis
    )
    data_ext = extend_dia_data(data, H, axis, num)
    L = n_local + 2 * H

    def apply_ext(v_ext):
        vp = jnp.pad(v_ext, (halo, halo))
        y = jnp.zeros(L, jnp.result_type(data_ext.dtype, v_ext.dtype))
        for k, off in enumerate(offsets):
            y = y + data_ext[k] * jax.lax.dynamic_slice(vp, (halo + off,), (L,))
        return y

    fwd = [(i, (i + 1) % num) for i in range(num)]
    bwd = [(i, (i - 1) % num) for i in range(num)]

    def exchange2(r, d):
        tails = jnp.stack([r[-H:], d[-H:]])
        heads = jnp.stack([r[:H], d[:H]])
        lefts = jax.lax.ppermute(tails, axis, fwd)
        rights = jax.lax.ppermute(heads, axis, bwd)
        r_ext = jnp.concatenate([lefts[0], r, rights[0]])
        d_ext = jnp.concatenate([lefts[1], d, rights[1]])
        return r_ext, d_ext

    r = b - spmv_dia_local_overlap(data, offsets, x0, halo, axis, num)
    rr0 = pdot(r, r)

    def res_of(r_local, rr):
        if policy.norm == "linf":
            return jax.lax.pmax(jnp.max(jnp.abs(r_local)), axis)
        return residual_norm(r_local, rr, rr0, policy.norm)

    def body(state):
        x, r, d, rho_prev, rr, it, started = state
        r_ext, d_ext = exchange2(r, d)  # the block's ONE wire pair

        def step(carry, _):
            x, r_e, d_e, rho_prev, it, started = carry
            rho = 1.0 / (2.0 * sigma - rho_prev)
            d_new = jnp.where(
                started,
                rho * rho_prev * d_e + (2.0 * rho / delta) * r_e,
                r_e / theta,
            )
            rho_new = jnp.where(started, rho, 1.0 / sigma)
            active = it < max_iter
            d_e = jnp.where(active, d_new, d_e)
            x = jnp.where(active, x + d_e[H : H + n_local], x)
            r_e = jnp.where(active, r_e - apply_ext(d_e), r_e)
            rho_prev = jnp.where(active, rho_new, rho_prev)
            return (x, r_e, d_e, rho_prev, it + active.astype(jnp.int32), True), None

        (x, r_ext, d_ext, rho_prev, it, started), _ = jax.lax.scan(
            step, (x, r_ext, d_ext, rho_prev, it, started), None, length=check
        )
        r = r_ext[H : H + n_local]
        d = d_ext[H : H + n_local]
        rr = rr if policy.norm == "linf" else pdot(r, r)
        return (x, r, d, rho_prev, rr, it, started)

    def cond(state):
        _x, r, _d, _rho, rr, it, _s = state
        res = res_of(r, rr)
        return jnp.logical_and(
            jnp.logical_or(it < min_iter, res >= tol), it < max_iter
        )

    state = (x0, r, jnp.zeros_like(b), jnp.asarray(0.0, dtype), rr0,
             jnp.int32(0), jnp.asarray(False))
    x, r, _d, _rho, rr, it, _ = jax.lax.while_loop(cond, body, state)
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def make_sharded_nonsym(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    axis: str = "x",
    M_local: Optional[Callable] = None,
    restart: int = 32,
    bounds=None,
    check_every: int = 16,
    m_aux_spec=None,
    donate: bool = True,
    s: int = 4,
    seed: int = 0,
    angle: float = 0.7,
    replace_every: int = 8,
):
    """Build a jitted row-block-sharded solver (DIA storage, halo-ppermute
    SpMV; all-gather fallback for bandwidth > n_local — the same operator
    construction as ``make_sharded_cg``).

    Returns ``solve(data, b, x0[, m_aux]) -> CGResult``; ``M_local`` as in
    ``make_sharded_cg`` (shard-equivariant, right preconditioning).
    ``method="chebyshev"`` (dot-free; requires ``bounds=(lo, hi)``) ignores
    ``M_local``.  ``method="fgmres"`` is the flexible form: ``M_local`` may
    be NONLINEAR (a fixed-budget inner solve) — the other methods require a
    linear shard-local M.
    """
    if method not in ("bicgstab", "gmres", "fgmres", "minres", "chebyshev", "idr"):
        raise ValueError(
            f"unknown method {method!r}; want "
            "bicgstab|gmres|fgmres|minres|chebyshev|idr"
        )
    if method == "chebyshev" and bounds is None:
        raise ValueError("chebyshev requires bounds=(lo, hi)")
    # one-call conveniences rebuild this factory per solve; the program is
    # fully determined by the static key below (matrix DATA is a runtime
    # argument), so cache the jitted product (parallel.mesh.factory_cache)
    from conjugategradient_tpu.parallel.mesh import factory_cache

    key = ("nonsym", A.offsets, A.shape, mesh, policy, method, axis, M_local,
           restart, bounds, check_every, m_aux_spec, donate, s, seed, angle,
           replace_every)
    return factory_cache(
        key,
        lambda: _build_sharded_nonsym(
            A, mesh, policy, method, axis, M_local, restart, bounds,
            check_every, m_aux_spec, donate, s, seed, angle, replace_every,
        ),
    )


def _build_sharded_nonsym(
    A, mesh, policy, method, axis, M_local, restart, bounds, check_every,
    m_aux_spec, donate, s, seed, angle, replace_every,
):
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    n_local = n // num
    halo = A.bandwidth
    offsets = A.offsets
    use_allgather = halo > n_local

    def local_solve(data, b, x0, m_aux):
        if use_allgather:
            op = lambda p: spmv_dia_allgather(data, offsets, p, axis, num)
        else:
            op = lambda p: spmv_dia_local_overlap(data, offsets, p, halo, axis, num)
        if method == "chebyshev":
            lo, hi = bounds
            if not use_allgather and 0 < int(check_every) * halo <= n_local:
                # extended-region stepping: check_every iterations per halo
                # exchange — 2 permutes + 1 psum per block (vs 2/SpMV)
                return sharded_chebyshev_block_loop(
                    data, offsets, b, x0, policy, axis, num, n,
                    float(lo), float(hi), check_every=check_every,
                )
            return sharded_chebyshev_loop(
                op, b, x0, policy, axis, n, float(lo), float(hi),
                check_every=check_every,
            )
        if method == "bicgstab":
            M = (lambda r: M_local(r, m_aux)) if M_local is not None else (lambda r: r)
            return sharded_bicgstab_loop(op, M, b, x0, policy, axis, n)
        M = (lambda r: M_local(r, m_aux)) if M_local is not None else None
        if method == "idr":
            return sharded_idr_loop(
                op, M, b, x0, policy, axis, n, s=s, seed=seed, angle=angle,
                replace_every=replace_every,
            )
        if method == "minres":
            return sharded_minres_loop(op, M, b, x0, policy, axis, n)
        return sharded_gmres_loop(
            op, M, b, x0, policy, axis, n, restart=restart,
            flexible=(method == "fgmres"),
        )

    in_specs = (P(None, axis), P(axis), P(axis))
    if M_local is not None:
        fn = local_solve
        # default: a row-sharded (n,) auxiliary; pass m_aux_spec for other
        # layouts (e.g. P(axis, None) for the (n, bs) block-Jacobi carrier)
        in_specs = in_specs + (m_aux_spec if m_aux_spec is not None else P(axis),)
    else:
        fn = lambda data, b, x0: local_solve(data, b, x0, None)
    shard_fn = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=CGResult(x=P(axis), iterations=P(), residual=P(), converged=P()),
    )
    return jax.jit(shard_fn, donate_argnums=(2,) if donate else ())


def make_sharded_lsmr(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    damp: float = 0.0,
    donate: bool = True,
):
    """Build a jitted row-block-sharded LSMR least-squares solver.

    Least squares needs BOTH A and A^T halo SpMVs: the transpose is built
    once on the host (offsets negate, columns roll — ``formats.transpose``)
    and rides as a second row-sharded (ndiags, n) operand.  Rectangular
    systems reach this path square-padded (zero rows add zero residual
    terms; zero columns stay exactly zero in the recurrence — both neutral
    in LSMR; see the facade routing).  Completes the distributed-twin
    coverage of the solver families: the halo machinery generalized from
    the reference's square-CG-only design
    (``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:88-113``).

    Returns ``(solve, A_t)``; call ``solve(data, dataT, b, x0)`` with both
    DIA data arrays placed ``P(None, axis)``.
    """
    from conjugategradient_tpu.core.formats import transpose as _transpose
    from conjugategradient_tpu.parallel.mesh import factory_cache

    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    n_local = n // num
    halo = A.bandwidth
    offsets = A.offsets
    use_allgather = halo > n_local
    A_t = _transpose(A)
    offsets_t = A_t.offsets
    key = ("lsmr", offsets, A.shape, mesh, policy, axis, float(damp), donate)

    def _build():
        return _build_sharded_lsmr(
            mesh, policy, axis, damp, donate, num, n, n_local, halo,
            offsets, offsets_t, use_allgather,
        )

    return factory_cache(key, _build), A_t


def _build_sharded_lsmr(
    mesh, policy, axis, damp, donate, num, n, n_local, halo, offsets,
    offsets_t, use_allgather,
):

    def lsmr_local(data, dataT, b, x0):
        if use_allgather:
            op = lambda p: spmv_dia_allgather(data, offsets, p, axis, num)
            opT = lambda p: spmv_dia_allgather(dataT, offsets_t, p, axis, num)
        else:
            op = lambda p: spmv_dia_local_overlap(data, offsets, p, halo, axis, num)
            opT = lambda p: spmv_dia_local_overlap(dataT, offsets_t, p, halo, axis, num)
        return sharded_lsmr_loop(op, opT, b, x0, policy, axis, n, damp=damp)

    shard_fn = jax.shard_map(
        lsmr_local,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(axis), P(axis)),
        out_specs=CGResult(x=P(axis), iterations=P(), residual=P(), converged=P()),
    )
    return jax.jit(shard_fn, donate_argnums=(3,) if donate else ())


def sharded_lsmr_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    damp: float = 0.0,
    dtype=None,
) -> CGResult:
    """One-call convenience: place the square-banded system row-block-
    sharded and LSMR-solve ``min ||A x - b|| (+ damp^2 ||x||^2)``."""
    import numpy as np

    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis=axis)
    solve, A_t = make_sharded_lsmr(
        A, mesh, policy, axis=axis, damp=damp, donate=False
    )
    dt = dtype or np.asarray(A.data).dtype
    row = NamedSharding(mesh, P(axis))
    col = NamedSharding(mesh, P(None, axis))
    data = jax.device_put(jnp.asarray(np.asarray(A.data, dtype=dt)), col)
    dataT = jax.device_put(jnp.asarray(np.asarray(A_t.data, dtype=dt)), col)
    b_dev = jax.device_put(jnp.asarray(np.asarray(b, dtype=dt)), row)
    x0_arr = np.zeros(A.n, dtype=dt) if x0 is None else np.asarray(x0, dtype=dt)
    x0_dev = jax.device_put(jnp.asarray(x0_arr), row)
    return solve(data, dataT, b_dev, x0_dev)


def sharded_nonsym_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    restart: int = 32,
    bounds=None,
    check_every: int = 16,
    dtype=None,
    s: int = 4,
    seed: int = 0,
    angle: float = 0.7,
    replace_every: int = 8,
) -> CGResult:
    """One-call convenience: place the system row-block-sharded and solve."""
    import numpy as np

    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis=axis)
    aux_arr = None if M_aux is None else np.asarray(M_aux)
    m_aux_spec = None
    if aux_arr is not None and aux_arr.ndim == 2:
        m_aux_spec = P(axis, None)
    solve = make_sharded_nonsym(
        A, mesh, policy, method=method, axis=axis, M_local=M_local,
        restart=restart, bounds=bounds, check_every=check_every,
        m_aux_spec=m_aux_spec, donate=False, s=s, seed=seed, angle=angle,
        replace_every=replace_every,
    )
    dt = dtype or np.asarray(A.data).dtype
    row = NamedSharding(mesh, P(axis))
    data = jax.device_put(
        jnp.asarray(np.asarray(A.data, dtype=dt)), NamedSharding(mesh, P(None, axis))
    )
    b_dev = jax.device_put(jnp.asarray(np.asarray(b, dtype=dt)), row)
    x0_arr = np.zeros(A.n, dtype=dt) if x0 is None else np.asarray(x0, dtype=dt)
    x0_dev = jax.device_put(jnp.asarray(x0_arr), row)
    args = [data, b_dev, x0_dev]
    if M_local is not None:
        aux_sh = row if m_aux_spec is None else NamedSharding(mesh, m_aux_spec)
        args.append(jax.device_put(jnp.asarray(aux_arr.astype(dt)), aux_sh))
    return solve(*args)
