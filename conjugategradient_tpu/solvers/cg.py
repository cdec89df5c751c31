"""Device-resident (preconditioned) Conjugate Gradient.

The single most important architectural lesson of the reference (SURVEY.md §3,
"hot-loop summary") is *where the loop control lives*: its fastest variant
keeps the whole CG loop in native device code with only two scalar
device→host reads per iteration (``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:201-270``),
while its slowest drives ~10 kernel launches and 3 blocking scalar reads per
iteration from the host (``Mgcg/HandmadeCL/MgcgCL/ConjugateGradientSingleGpu.cs:226-296``).

Here the answer is final: the entire loop is a ``lax.while_loop`` inside one
jitted program.  Scalars (alpha, beta, the residual, the iteration counter)
never leave the device; the convergence predicate itself is evaluated on-device.
Per iteration: 1 SpMV + 2 dots + 3 fused vector updates — exactly the
reference recurrence (``R/CG.R:38-58``), with zero host round-trips.

Supports plain CG and preconditioned CG (pass ``M``: z = M(r) must be an SPD
preconditioner application, e.g. a multigrid V-cycle from
``conjugategradient_tpu.precond``).

The recurrence itself lives in exactly one place (``_make_step``); the three
drivers — ``cg_solve`` (while_loop), ``cg_solve_traced`` (scan + history) and
``cg_solve_chunked`` (checkpointable scans) — share it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.ops.blas import dot as _dot
from conjugategradient_tpu.ops.blas import residual_norm
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.policy import ConvergencePolicy, NotConvergedError


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solve outcome; a pytree so it can cross ``jit`` boundaries intact.

    ``converged=False`` means max_iteration was exhausted — the XLA-legal
    encoding of the reference's ApplicationException
    (``ConjugateGradient.cs:73``); call ``raise_if_diverged()`` to get the
    throwing behaviour back on the host.
    """

    x: jax.Array
    iterations: jax.Array  # int32
    residual: jax.Array
    converged: jax.Array  # bool

    def raise_if_diverged(self) -> "CGResult":
        if not bool(self.converged):
            raise NotConvergedError(
                f"CG did not converge within {int(self.iterations)} iterations "
                f"(residual={float(self.residual):.3e})"
            )
        return self


jax.tree_util.register_dataclass(
    CGResult, data_fields=["x", "iterations", "residual", "converged"], meta_fields=[]
)


def _safe_div(num, den):
    """num/den with 0 when den == 0 (keeps the loop NaN-free when the initial
    guess is already exact and min_iteration forces extra sweeps)."""
    ok = den != 0
    return jnp.where(ok, num, 0.0) / jnp.where(ok, den, 1.0)


def _apply_M(M, r):
    """Preconditioner application.  ``M`` is a callable z = M(r), or a
    ``(fn, state)`` pair applied as ``fn(state, r)`` — the pytree-argument
    form that keeps large preconditioner state (e.g. a multigrid hierarchy)
    out of jit closure constants (closure constants are baked into the
    compiled program)."""
    if M is None:
        return r
    if isinstance(M, tuple):
        fn, state = M
        return fn(state, r)
    return M(r)


def _cg_init(op, b, x0, M, dot, dtype, project=None, project_r=None):
    """Initial recurrence state (x, r, p, rz, rr) from b and the guess."""
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    r = b - op(x)
    if project_r is not None:
        r = project_r(r)
    z = _apply_M(M, r)
    p = z if project is None else project(z)
    rz = dot(r, z)
    rr = dot(r, r)
    return x, r, p, rz, rr


def _make_step(op, M, dot, project=None, project_r=None):
    """THE CG recurrence (``R/CG.R:38-58``), written once.

    Returns ``step(x, r, p, rz, rr) -> ((x, r, p, rz, rr), (alpha, beta))``
    performing one unconditional iteration.  NaN-free even at exact
    convergence (r = 0) via ``_safe_div`` — required by the masked drivers,
    which keep executing the step after convergence and select the old state.
    The step's scalars are returned because they are the Lanczos coefficients
    in disguise (see ``solvers.eigen.spectrum_from_cg``); drivers that don't
    record them drop them.

    ``project`` (optional) maps the preconditioned residual before it enters
    the direction update — the hook deflated CG uses to keep every search
    direction A-orthogonal to the deflation space (``solvers.deflation``,
    Saad/Yeung/Erhel/Guyomarc'h def-CG).  Identity when None.

    ``project_r`` (optional) re-projects the RESIDUAL after every update
    (``r - AW E⁻¹ Wᵀ r``, which zeroes ``Wᵀ r`` exactly) — the DEF-form
    stabilisation (Tang/Nabben/Vuik/Erlangga, J. Sci. Comput. 39, 2009).
    Load-bearing in fp32: the un-reprojected invariant drifts at
    O(eps·kappa) per step, and with a 1e-6 outlier against an O(1) bulk the
    recurrence visibly DIVERGES after ~20 iterations (measured on the
    outlier workload); re-projection pins the drift at eps32 per step.  The
    deflated components it removes from ``r`` are restored exactly by the
    caller's final Galerkin correction (``deflated_cg_solve``).
    """

    def step(x, r, p, rz, rr):
        Ap = op(p)
        alpha = _safe_div(rz, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        if project_r is not None:
            r = project_r(r)
        z = _apply_M(M, r)
        rz_new = dot(r, z)
        rr_new = dot(r, r)
        beta = _safe_div(rz_new, rz)
        p = (z if project is None else project(z)) + beta * p
        return (x, r, p, rz_new, rr_new), (alpha, beta)

    return step


def _make_masked_step(op, M, dot):
    """Fixed-trip-count variant: ``step(state, active) -> (state, (alpha,
    beta))`` where ``state = (x, r, p, rz, rr, it)``.  When ``active`` is
    False the state is frozen (scalar-predicate selects, fused by XLA) —
    iterations after convergence are no-ops, so scans of static length
    terminate correctly (the scalars of frozen steps are meaningless;
    consumers truncate by the final iteration count)."""
    raw = _make_step(op, M, dot)

    def step(state, active):
        x, r, p, rz, rr, it = state
        new, coeffs = raw(x, r, p, rz, rr)
        sel = lambda a, b: jnp.where(active, a, b)
        x2, r2, p2, rz2, rr2 = (sel(a, b) for a, b in zip(new, (x, r, p, rz, rr)))
        return (x2, r2, p2, rz2, rr2, it + active.astype(jnp.int32)), coeffs

    return step


def cg_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    project: Optional[Callable] = None,
    project_r: Optional[Callable] = None,
) -> CGResult:
    """Solve A x = b by (preconditioned) CG, fully on device.

    ``project`` is the deflation hook (see ``solvers.deflation``): applied to
    the preconditioned residual wherever it enters the direction update.
    ``project_r`` re-projects the residual itself every iteration (the
    fp32-stable DEF form — see ``_make_step``); callers using it must restore
    the deflated solution components afterwards (``deflated_cg_solve`` does).

    Traceable: call under ``jax.jit`` (and inside ``shard_map`` — see
    ``conjugategradient_tpu.parallel`` for the collective-dot variant).

    fp32 + absolute norms caveat: a fast-converging recurrence can underflow
    ``r`` to exactly zero (fp32 min normal ~1e-38) well before an absolute
    tolerance on a large-scaled system is meaningful — the recurrence then
    freezes and reports residual 0 even though the *true* residual sits at
    the fp32 drift floor (~1e-5 relative).  For fp64-grade absolute
    tolerances on fp32 hardware use ``solvers.refine.refined_solve``, which
    rescales every outer pass; for plain fp32 solves prefer ``norm="rel_l2"``.
    """
    op = as_operator(A)
    n = b.size
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = jnp.int32(policy.resolve_max(n))
    dot = lambda u, v: _dot(u, v, precise=precise_dot)

    x, r, p, rz, rr = _cg_init(
        op, b, x0, M, dot, dtype, project=project, project_r=project_r
    )
    rr0 = rr

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    def cond(state):
        _, r, _, _, rr, it = state
        res = res_of(r, rr)
        unconverged = jnp.logical_or(it < min_iter, res >= tol)
        return jnp.logical_and(unconverged, it < max_iter)

    step = _make_step(op, M, dot, project=project, project_r=project_r)

    def body(state):
        x, r, p, rz, rr, it = state
        new, _coeffs = step(x, r, p, rz, rr)
        return (*new, it + 1)

    x, r, p, rz, rr, it = jax.lax.while_loop(cond, body, (x, r, p, rz, rr, jnp.int32(0)))
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def cg_solve_traced(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    num_steps: int = 100,
    precise_dot: bool = False,
    with_coefficients: bool = False,
):
    """Fixed-length CG that records the residual at every iteration.

    The structured observability the reference only had as per-iteration
    ``Console.WriteLine`` traces (SURVEY.md §5.5) — here a dense
    ``(num_steps,)`` residual history comes back as a device array from a
    single ``lax.scan``.  Iterations after convergence freeze the state, so
    the trailing history is flat.

    Returns ``(CGResult, residual_history)`` — or, with
    ``with_coefficients=True``, ``(CGResult, residual_history, (alphas,
    betas))`` where the two ``(num_steps,)`` arrays are the recurrence
    scalars of every iteration.  They cost nothing extra (the scan computes
    them anyway) and feed ``solvers.eigen.spectrum_from_cg``: the CG run IS a
    Lanczos process, so the extremal eigenvalues and condition number of the
    (preconditioned) operator fall out of a solve for free — the diagnostics
    the reference prototyped as commented-out R probes (``R/CG.R:26-27``) and
    a separate dense Jacobi eigensolver (``SparseMatrix.cs:234-372``).
    Entries past ``iterations`` are from frozen steps; truncate before use.
    """
    op = as_operator(A)
    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)

    x, r, p, rz, rr = _cg_init(op, b, x0, M, dot, dtype)
    rr0 = rr

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    masked = _make_masked_step(op, M, dot)

    def step(state, _):
        _, r, _, _, rr, it = state
        active = jnp.logical_or(it < min_iter, res_of(r, rr) >= tol)
        new_state, coeffs = masked(state, active)
        return new_state, (res_of(new_state[1], new_state[4]), *coeffs)

    state, (history, alphas, betas) = jax.lax.scan(
        step, (x, r, p, rz, rr, jnp.int32(0)), None, length=num_steps
    )
    x, r, p, rz, rr, it = state
    res = res_of(r, rr)
    converged = jnp.logical_and(res < tol, it >= min_iter)
    result = CGResult(x=x, iterations=it, residual=res, converged=converged)
    if with_coefficients:
        return result, history, (alphas, betas)
    return result, history


def cg_solve_chunked(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    chunk: int = 200,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    callback: Optional[Callable] = None,
    precise_dot: bool = False,
) -> CGResult:
    """Checkpointable CG: runs in jitted ``chunk``-iteration scans with a host
    touchpoint between chunks.

    The aux subsystem the reference lacks (SURVEY.md §5.4): between chunks the
    full recurrence state is downloaded and (optionally) persisted to
    ``checkpoint_path`` — a later call with the same path resumes the *same*
    Krylov sequence, surviving process death mid-solve.  ``callback(state)``
    receives a ``utils.checkpoint.CGState`` per chunk (structured progress
    stream).  Per-chunk host cost is one small sync — amortised over ``chunk``
    device-resident iterations.

    The matrix — and, when ``M`` is given as a ``(fn, state)`` pair, the
    preconditioner state — enter the jitted chunk as pytree *arguments*, not
    closure constants: this path exists for the largest long-running solves,
    where closure constants would bake the whole system into the compiled
    program (a 1.3 GB band-160 matrix became a 1.2 GB executable and
    minutes of compile on an H100).
    """
    import numpy as np

    from conjugategradient_tpu.utils import checkpoint as ckpt

    dtype = b.dtype
    tol = jnp.asarray(policy.tol, dtype)
    min_iter = jnp.int32(policy.min_iteration)
    max_iter = policy.resolve_max(b.size)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    if isinstance(M, tuple):
        M_fn, M_state = M
    else:
        M_fn = None if M is None else (lambda _, r: M(r))
        M_state = None

    prev = ckpt.maybe_resume(checkpoint_path) if resume else None
    if prev is not None:
        x = jnp.asarray(prev.x, dtype)
        r = jnp.asarray(prev.r, dtype)
        p = jnp.asarray(prev.p, dtype)
        rz = jnp.asarray(prev.rz, dtype)
        rr = jnp.asarray(prev.rr, dtype)
        rr0 = jnp.asarray(prev.rr0, dtype)
        it = jnp.int32(prev.iteration)
    else:
        op0 = as_operator(A)
        M0 = None if M_fn is None else (M_fn, M_state)
        x, r, p, rz, rr = _cg_init(op0, b, x0, M0, dot, dtype)
        rr0 = rr
        it = jnp.int32(0)

    def res_of(r, rr, rr0):
        return residual_norm(r, rr, rr0, policy.norm)

    @jax.jit
    def run_chunk(A_, M_state_, x, r, p, rz, rr, rr0, it):
        op = as_operator(A_)
        M_ = None if M_fn is None else (M_fn, M_state_)
        masked = _make_masked_step(op, M_, dot)

        def step(state, _):
            _, r, _, _, rr, it = state
            active = jnp.logical_and(
                jnp.logical_or(it < min_iter, res_of(r, rr, rr0) >= tol),
                it < jnp.int32(max_iter),
            )
            return masked(state, active)[0], None

        (x, r, p, rz, rr, it), _ = jax.lax.scan(
            step, (x, r, p, rz, rr, it), None, length=chunk
        )
        return x, r, p, rz, rr, it, res_of(r, rr, rr0)

    while True:
        x, r, p, rz, rr, it, res = run_chunk(A, M_state, x, r, p, rz, rr, rr0, it)
        # ONE batched readback per chunk (each separate scalar/array read
        # would wait on the device on its own)
        x_h, r_h, p_h, rz_h, rr_h, rr0_h, it_host, res_host = (
            jax.device_get((x, r, p, rz, rr, rr0, it, res))
        )
        it_host = int(it_host)
        res_host = float(res_host)
        state = ckpt.CGState(
            x=np.asarray(x_h),
            r=np.asarray(r_h),
            p=np.asarray(p_h),
            rz=float(rz_h),
            rr=float(rr_h),
            rr0=float(rr0_h),
            iteration=it_host,
        )
        if checkpoint_path:
            ckpt.save_state(checkpoint_path, state)
        if callback is not None:
            callback(state)
        converged = res_host < float(policy.tol) and it_host >= policy.min_iteration
        if converged or it_host >= max_iter:
            break

    return CGResult(
        x=x,
        iterations=it,
        residual=res,
        converged=jnp.logical_and(res < tol, it >= min_iter),
    )
