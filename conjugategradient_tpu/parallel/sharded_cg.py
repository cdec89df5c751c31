"""Row-block-sharded CG over a device mesh — the flagship distributed solver.

Device-mesh re-design of the reference's multi-GPU CG host
(``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:11-596``).  Its per
-iteration choreography was: host-threaded ``SyncP`` halo staging →
``Solve1`` fan-out (SpMV + partial p·Ap) → host allreduce alpha → ``Solve2``
fan-out (x,r update + partial r·r) → host allreduce → convergence check →
``Solve3`` fan-out (p = r + beta p), with 2x(deviceCount) staged halo copies
and 3x(deviceCount) scalar D2H reads per iteration (SURVEY.md §3.1 step 5).

Here the *entire solve* — halo exchange, SpMV, dots, convergence predicate,
iteration loop — is one jitted SPMD program under ``shard_map``:

- ``jax.lax.psum`` over the mesh axis replaces the host-side
  ``resultsDot.Sum()`` allreduce (``ConjugateGradientParallelGpu.cs:463,499,525``),
- ``jax.lax.ppermute`` neighbor shifts replace the staged P2Host/P2Device
  boundary copies,
- XLA program order inside the ``while_loop`` replaces the bulk-synchronous
  ``Parallel.For`` thread barriers,
- scalars (alpha, beta, residual, iteration count) are replicated on-device —
  zero host round-trips for any number of iterations or devices.

The same program runs on a single-host ICI mesh or a multi-host DCN-spanning
mesh; only the Mesh construction changes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.formats import DiaMatrix
from conjugategradient_tpu.ops.blas import residual_norm as _residual_norm
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
from conjugategradient_tpu.parallel.halo import (
    spmv_dia_allgather,
    spmv_dia_local_overlap,
)
from conjugategradient_tpu.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def _pdot(a, b, axis):
    # ravel: locals may be grid-shaped (the stencil MGCG path); for 1-D
    # inputs this is a no-op and lowers to the same fused dot
    return jax.lax.psum(jnp.dot(a.ravel(), b.ravel(), precision=MATMUL_PRECISION,
                                preferred_element_type=a.dtype), axis)


def _pdot_fused(pairs, axis):
    """Several dots in ONE collective: local partials are stacked into a
    single (k,) vector and psum'd together.

    The reference pays one host allreduce per dot (``resultsDot.Sum()`` at
    ``ConjugateGradientParallelGpu.cs:463,499,525``); standard CG needs its
    dots at two separate dependency points, so even on-device it costs two
    allreduce latencies per iteration.  The communication-reduced variants
    below restructure the recurrence so all scalars are needed at the SAME
    point — this helper then makes them one wire message.
    """
    parts = jnp.stack(
        [jnp.dot(a.ravel(), b.ravel(), precision=MATMUL_PRECISION,
                 preferred_element_type=a.dtype) for a, b in pairs]
    )
    return jax.lax.psum(parts, axis)


def _presidual(r_local, rr, rr0, norm, axis):
    if norm == "linf":
        return jax.lax.pmax(jnp.max(jnp.abs(r_local)), axis)
    return _residual_norm(r_local, rr, rr0, norm)


def sharded_cg_loop(
    op,
    M,
    b,
    x0,
    policy: ConvergencePolicy,
    axis: str,
    n_global: int,
    variant: str = "cg",
    project=None,
    project_r=None,
    s: int = 4,
    cacg_basis=None,
) -> CGResult:
    """The sharded CG recurrence, format-agnostic: ``op``/``M`` act on this
    shard's local slice (with whatever collectives they need inside), dots are
    ``psum`` over ``axis``.  Shared by the DIA solver below, the
    general-sparsity (CSR/ELL exact-halo) solver in ``sharded_general`` and
    the explicit shard_map MGCG fine loop.

    ``project``/``project_r`` are the deflation hooks (``solvers.deflation``;
    shard-local functions — a ``Deflation.with_axis(axis)`` carries its own
    psum): direction projection and the fp32-stabilising residual
    re-projection, exactly as in the single-device ``_make_step``.  Only the
    textbook ``"cg"`` variant supports them (the communication-reduced
    recurrences carry derived state the projections would desynchronise).
    Runs inside ``shard_map``; the whole loop is one ``lax.while_loop`` —
    scalars never leave the devices (the re-design of the reference's
    host-allreduce choreography, ``ConjugateGradientParallelGpu.cs:424-565``).

    ``variant`` selects the communication structure (identical maths in exact
    arithmetic; see the variant docstrings for the fp caveats):

    - ``"cg"`` — textbook recurrence: the p·Ap dot and the r·z / r·r pair sit
      at two dependency points, so every iteration pays TWO allreduce
      latencies (XLA fuses the adjacent rz/rr pair into one collective).
    - ``"cg1"`` — Chronopoulos–Gear single-reduce CG: one fused (3,)-psum per
      iteration, at the cost of two extra vector recurrences (HBM traffic).
      Wins when allreduce latency > two axpy passes — i.e. multi-host DCN
      meshes, or large ICI meshes on small shards.
    - ``"pipelined"`` — Ghysels–Vanroose: like cg1, but the SpMV is made data
      -independent of the reduction so XLA's latency-hiding scheduler can run
      the allreduce UNDER the SpMV (async collectives) instead of before it.
    - ``"cacg"`` — s-step communication-avoiding CG (``solvers.cacg``): TWO
      reductions per ``s`` iterations (one fused (2s+1)^2 Gram psum + one
      block-boundary true-residual norm) — the latency-bound extreme of the
      axis WITHOUT Chebyshev's spectral-bounds requirement — at ~2x the
      SpMV work (2s matvecs per s steps incl. the replacement).
      Unpreconditioned and l2/rel_l2 only; ``s`` sets the step block
      (keep <= 4 in fp32).
    """
    if variant == "cacg":
        if project is not None or project_r is not None:
            raise ValueError("deflation hooks require variant='cg'")
        from conjugategradient_tpu.solvers.cacg import cacg_loop

        pdot = lambda u, v: jax.lax.psum(
            jnp.dot(u.ravel(), v.ravel(), precision=MATMUL_PRECISION,
                    preferred_element_type=u.dtype), axis
        )
        # HIGHEST precision on the local Gram block (cf. solvers.cacg)
        pgram = lambda V: jax.lax.psum(
            jnp.matmul(V, V.T, precision=MATMUL_PRECISION), axis
        )
        return cacg_loop(
            op, b, x0, policy, int(s), dot=pdot, gram=pgram,
            n_global=n_global, basis=cacg_basis,
        )
    if variant in ("cg1", "pipelined"):
        if project is not None or project_r is not None:
            raise ValueError(
                "deflation hooks require variant='cg' (the communication-"
                "reduced recurrences carry derived state the projections "
                "would desynchronise)"
            )
        return _cg1_loop(
            op, M, b, x0, policy, axis, n_global, pipelined=variant == "pipelined"
        )
    if variant != "cg":
        raise ValueError(f"unknown CG variant {variant!r}; want cg|cg1|pipelined|cacg")
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)
    norm = policy.norm

    x = x0
    r = b - op(x)
    if project_r is not None:
        r = project_r(r)
    z = M(r)
    p = z if project is None else project(z)
    rz = _pdot(r, z, axis)
    rr = _pdot(r, r, axis)
    rr0 = rr

    def res_of(r, rr):
        return _presidual(r, rr, rr0, norm, axis)

    def cond(state):
        _, r, _, _, rr, it = state
        res = res_of(r, rr)
        return jnp.logical_and(jnp.logical_or(it < min_iter, res >= tol), it < max_iter)

    def body(state):
        x, r, p, rz, rr, it = state
        Ap = op(p)
        alpha = _safe_div(rz, _pdot(p, Ap, axis))
        x = x + alpha * p
        r = r - alpha * Ap
        if project_r is not None:
            r = project_r(r)
        z = M(r)
        rz_new = _pdot(r, z, axis)
        rr_new = _pdot(r, r, axis)
        beta = _safe_div(rz_new, rz)
        p = (z if project is None else project(z)) + beta * p
        return (x, r, p, rz_new, rr_new, it + 1)

    x, r, p, rz, rr, it = jax.lax.while_loop(cond, body, (x, r, p, rz, rr, jnp.int32(0)))
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def _cg1_loop(op, M, b, x0, policy, axis, n_global, pipelined: bool) -> CGResult:
    """Chronopoulos–Gear single-reduce CG, optionally Ghysels–Vanroose
    pipelined.  Same Krylov sequence as ``sharded_cg_loop`` in exact
    arithmetic.

    The restructuring: introduce u = M r and w = A u as carried state, so
    that the three scalars an iteration needs — γ=(r,u), δ=(w,u) for α/β and
    (r,r) for the convergence predicate — are all available at ONE dependency
    point and ship as a single fused (3,)-psum (``_pdot_fused``).  The extra
    price is two more recurrences (s = A p, plus q = M s / z = A q when
    pipelined): pure local HBM traffic traded against a wire latency.  The
    reference's multi-GPU loop pays three sequential host allreduces per
    iteration (``ConjugateGradientParallelGpu.cs:463,499,525``) — this is the
    opposite end of that design axis.

    ``pipelined=False`` (cg1): u = M r and w = A u are recomputed from the
    fresh residual every iteration; the fused reduction sits between them and
    the updates — one latency per iteration, numerically closest to PCG.

    ``pipelined=True`` (Ghysels & Vanroose 2014): u and w advance by AXPY
    recurrences (u -= α q, w -= α z) and the body computes m = M w, n = A m —
    which have NO data dependence on the fused reduction of the same body, so
    XLA's latency-hiding scheduler is free to run the psum underneath the
    SpMV (async collective-start/done).  Costs: two more vectors of state,
    and the recurrences let u/w drift from M r / A u in finite precision —
    the classic pipelined-CG trade (use for latency-bound meshes, not for
    squeezing the last digits; the convergence check also lags one iteration,
    so it never under-runs the tolerance, and the reported final residual is
    recomputed fresh).
    """
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)
    norm = policy.norm

    x = x0
    r = b - op(x)
    u = M(r)
    w = op(u)
    gamma, delta, rr = _pdot_fused(((r, u), (w, u), (r, r)), axis)
    rr0 = rr
    zerov = jnp.zeros_like(b)
    zero = jnp.zeros((), dtype)

    def res_of(r, rr):
        return _presidual(r, rr, rr0, norm, axis)

    def scalars(gamma, delta, gamma_prev, alpha_prev):
        # beta = 0 on the first trip (gamma_prev = 0 -> safe_div = 0), which
        # collapses alpha to gamma/delta exactly as plain CG's first step
        beta = _safe_div(gamma, gamma_prev)
        alpha = _safe_div(gamma, delta - _safe_div(beta * gamma, alpha_prev))
        return alpha, beta

    if not pipelined:
        # state scalars (gamma, delta, rr) always describe the CURRENT (r, u, w)
        def cond(state):
            x, r, u, w, p, s, g_prev, a_prev, gamma, delta, rr, it = state
            res = res_of(r, rr)
            return jnp.logical_and(jnp.logical_or(it < min_iter, res >= tol), it < max_iter)

        def body(state):
            x, r, u, w, p, s, g_prev, a_prev, gamma, delta, rr, it = state
            alpha, beta = scalars(gamma, delta, g_prev, a_prev)
            p = u + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            u = M(r)
            w = op(u)
            g2, d2, rr2 = _pdot_fused(((r, u), (w, u), (r, r)), axis)
            return (x, r, u, w, p, s, gamma, alpha, g2, d2, rr2, it + 1)

        state = (x, r, u, w, zerov, zerov, zero, zero, gamma, delta, rr, jnp.int32(0))
        x, r, u, w, p, s, g_prev, a_prev, gamma, delta, rr, it = jax.lax.while_loop(
            cond, body, state
        )
        res = res_of(r, rr)
    else:
        # dots are computed at the TOP of the body over the state's (r, u, w),
        # next to the independent m = M w / n = A m — the overlap window.  The
        # state's rr therefore describes the PREVIOUS body's r: the predicate
        # lags one update (conservative), and the final residual is
        # recomputed after the loop.
        def cond(state):
            x, r, u, w, p, s, q, z, g_prev, a_prev, rr, it = state
            res = res_of(r, rr)
            return jnp.logical_and(jnp.logical_or(it < min_iter, res >= tol), it < max_iter)

        def body(state):
            x, r, u, w, p, s, q, z, g_prev, a_prev, _rr, it = state
            gamma, delta, rr = _pdot_fused(((r, u), (w, u), (r, r)), axis)
            m = M(w)
            n = op(m)  # <- no data dependence on the psum above: overlappable
            alpha, beta = scalars(gamma, delta, g_prev, a_prev)
            z = n + beta * z
            q = m + beta * q
            p = u + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            u = u - alpha * q
            w = w - alpha * z
            return (x, r, u, w, p, s, q, z, gamma, alpha, rr, it + 1)

        state = (x, r, u, w, zerov, zerov, zerov, zerov, zero, zero, rr, jnp.int32(0))
        x, r, u, w, p, s, q, z, g_prev, a_prev, rr, it = jax.lax.while_loop(cond, body, state)
        rr = _pdot(r, r, axis)  # fresh: the carried rr lags one update
        res = res_of(r, rr)

    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def make_sharded_cg(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    M_local: Optional[Callable] = None,
    donate: bool = True,
    variant: str = "cg",
    deflation=None,
    s: int = 4,
):
    """Build a jitted sharded solver.

    ``deflation`` (a ``solvers.deflation.Deflation``, built once on the full
    system) turns the program into distributed def-CG: the basis rides
    row-sharded as an extra pytree argument to the returned ``solve`` (pass
    the SAME Deflation object; this builder shards it), the (k,) Galerkin
    contraction psums over the mesh axis, the k x k coarse solve is
    replicated, and the recurrence applies the fp32-stable residual
    re-projection each iteration plus the final Galerkin correction — the
    distributed form of ``solvers.deflation.deflated_cg_solve``.

    Returns ``solve(data, b, x0) -> CGResult`` — or, when ``M_local`` is
    given, ``solve(data, b, x0, m_aux) -> CGResult`` where ``m_aux`` is a
    row-sharded (n,) auxiliary array (e.g. the inverse diagonal for Jacobi)
    and ``M_local(r_local, m_aux_local)`` applies the preconditioner to this
    shard's slice.  ``M_local`` must be equivariant to row sharding (pointwise
    or local-stencil operations qualify).

    ``A`` supplies static structure only (offsets, shape); the DIA ``data``
    array is a runtime argument so one compiled program serves many systems
    with the same sparsity (the reference re-uploads values through
    ``Initialize`` the same way, ``ConjugateGradientParallelGpu.cs:358-379``).

    Requires ``A.n % num_shards == 0`` (use ``core.partition.pad_system``).
    When bandwidth <= n_local the SpMV uses one-hop ``ppermute`` halos (the
    reference's rank±1 chain topology, SURVEY.md §5.8); wider bandwidths fall
    back to the all-gather formulation (``halo.spmv_dia_allgather`` — the
    reference's global-length ``vectorP`` worst case,
    ``ConjugateGradientParallelGpu.cs:321``).  For general CSR/ELL sparsity
    see ``parallel.sharded_general`` (exact halo ranges, multi-hop rings).
    """
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    if variant == "cacg" and (M_local is not None or deflation is not None):
        raise ValueError(
            "variant='cacg' is unpreconditioned (fold diagonal scaling into "
            "A) and takes no deflation; use variant='cg' for those"
        )
    if deflation is None:
        # the program is fully static in this key (matrix DATA is a runtime
        # argument); cache so one-call conveniences / facade mesh= routes
        # skip the re-trace (parallel.mesh.factory_cache).  Deflated builds
        # stay uncached (the Deflation object's shapes enter the trace).
        from conjugategradient_tpu.parallel.mesh import factory_cache

        key = ("cg", A.offsets, A.shape, mesh, policy, axis, M_local,
               donate, variant, s)
        return factory_cache(
            key,
            lambda: _build_sharded_cg(
                A, mesh, policy, axis, M_local, donate, variant, None, s
            ),
        )
    return _build_sharded_cg(
        A, mesh, policy, axis, M_local, donate, variant, deflation, s
    )


def _build_sharded_cg(A, mesh, policy, axis, M_local, donate, variant, deflation, s):
    num = mesh.shape[axis]
    n = A.n
    n_local = n // num
    halo = A.bandwidth
    offsets = A.offsets
    use_allgather = halo > n_local

    def local_solve(data, b, x0, m_aux, defl):
        if use_allgather:
            op = lambda p: spmv_dia_allgather(data, offsets, p, axis, num)
        else:
            # halo-overlap formulation: interior compute carries no data
            # dependence on the ppermute (see halo.spmv_dia_local_overlap)
            op = lambda p: spmv_dia_local_overlap(data, offsets, p, halo, axis, num)

        def M(r):
            return M_local(r, m_aux) if M_local is not None else r

        basis = None
        if variant == "cacg" and not use_allgather and 0 < s * halo <= n_local:
            # MATRIX-POWERS KERNEL: neighbors' boundary ROWS are exchanged
            # once per solve (the matrix is loop-invariant), then each outer
            # step's whole 2s+1-column basis costs ONE fused widened halo
            # exchange instead of 2s-1 per-SpMV exchanges
            from conjugategradient_tpu.parallel.halo import (
                dia_basis_powers,
                extend_dia_data,
            )

            data_ext = extend_dia_data(data, s * halo, axis, num)
            basis = lambda p_, r_: dia_basis_powers(
                data_ext, offsets, p_, r_, s, halo, axis, num
            )

        if defl is None:
            return sharded_cg_loop(
                op, M, b, x0, policy, axis, n, variant=variant, s=s,
                cacg_basis=basis,
            )
        d = defl.with_axis(axis)
        res = sharded_cg_loop(
            op, M, b, d.galerkin_correct(x0, b - op(x0)), policy, axis, n,
            variant=variant, project=d.project_direction,
            project_r=d.project_residual,
        )
        # final Galerkin correction (see deflated_cg_solve): restore the
        # span{W} solution components project_r kept out of the recurrence
        x = d.galerkin_correct(res.x, b - op(res.x))
        return dataclasses.replace(res, x=x)

    in_specs = (P(None, axis), P(axis), P(axis))
    if M_local is not None:
        in_specs = in_specs + (P(axis),)
    if deflation is not None:
        # basis rows shard with the vectors; the k x k factor and scale are
        # replicated (leaf order: W, AW, chol_E, scale)
        defl_spec = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(deflation),
            [P(axis, None), P(axis, None), P(), P()],
        )
        in_specs = in_specs + (defl_spec,)

    has_m, has_d = M_local is not None, deflation is not None
    if has_m and has_d:
        fn = local_solve
    elif has_m:
        fn = lambda data, b, x0, m_aux: local_solve(data, b, x0, m_aux, None)
    elif has_d:
        fn = lambda data, b, x0, defl: local_solve(data, b, x0, None, defl)
    else:
        fn = lambda data, b, x0: local_solve(data, b, x0, None, None)
    shard_fn = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=CGResult(x=P(axis), iterations=P(), residual=P(), converged=P()),
    )
    donate_argnums = (2,) if donate else ()
    return jax.jit(shard_fn, donate_argnums=donate_argnums)


def sharded_cg_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    dtype=None,
    variant: str = "cg",
    deflation=None,
    s: int = 4,
) -> CGResult:
    """One-call convenience: place the system on the mesh and solve.

    ``A`` may hold host (numpy) or device data; arrays are device_put with the
    row-block sharding so no resharding happens at dispatch.  For a
    preconditioned solve pass both ``M_local(r_local, aux_local)`` and the
    global (n,) ``M_aux`` array (sharded here).  ``deflation`` (from
    ``make_deflation`` on the full system) runs distributed def-CG — the
    probe-once / solve-many time-stepping pattern at mesh scale.
    """
    import numpy as np

    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis=axis)
    solve = make_sharded_cg(
        A, mesh, policy, axis=axis, M_local=M_local, donate=False,
        variant=variant, deflation=deflation, s=s,
    )
    dt = dtype or np.asarray(A.data).dtype
    row_sharding = NamedSharding(mesh, P(axis))
    data = jax.device_put(jnp.asarray(np.asarray(A.data, dtype=dt)), NamedSharding(mesh, P(None, axis)))
    b_dev = jax.device_put(jnp.asarray(np.asarray(b, dtype=dt)), row_sharding)
    x0_arr = np.zeros(A.n, dtype=dt) if x0 is None else np.asarray(x0, dtype=dt)
    x0_dev = jax.device_put(jnp.asarray(x0_arr), row_sharding)
    args = [data, b_dev, x0_dev]
    if M_local is not None:
        args.append(jax.device_put(jnp.asarray(np.asarray(M_aux, dtype=dt)), row_sharding))
    if deflation is not None:
        basis_sh = NamedSharding(mesh, P(axis, None))
        rep = NamedSharding(mesh, P())
        args.append(
            dataclasses.replace(
                deflation,
                W=jax.device_put(jnp.asarray(deflation.W, dt), basis_sh),
                AW=jax.device_put(jnp.asarray(deflation.AW, dt), basis_sh),
                chol_E=jax.device_put(jnp.asarray(deflation.chol_E, dt), rep),
                scale=jax.device_put(jnp.asarray(deflation.scale, dt), rep),
            )
        )
    return solve(*args)
