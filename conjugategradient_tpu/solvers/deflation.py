"""Deflated / recycled CG: spectral deflation for SEQUENCES of solves.

Production context the reference was built for: its author's SPH solver
calls the pressure-projection CG every time step with the SAME matrix and a
new right-hand side (the reference API's ``Initialize()`` once /
``Solve()`` repeatedly split, ``Mgcg/cuBlas/Mgcg/ConjugateGradientGpu.cs:84-89``,
encodes exactly this).  Plain CG pays for the lowest eigenmodes — the modes
that dominate kappa — again on every solve.  Deflation computes them ONCE
(an m-step device Lanczos probe) and removes them from every subsequent
Krylov iteration: the effective condition number drops from
lambda_max/lambda_1 to lambda_max/lambda_{k+1}.

Device mapping: the per-iteration deflation work is two (n, k) x (k,)
matmuls plus a k x k triangular solve — tall-skinny, bandwidth-bound work,
negligible next to the SpMV it rides on.  The basis (W, AW, chol(WᵀAW)) is a
registered pytree, so it flows through ``jit`` as an ARGUMENT (never a
closure constant) and shards over the mesh like any other
operand.

Algorithm: def-CG (Saad, Yeung, Erhel, Guyomarc'h, SIAM J. Sci. Comput.
21(5), 2000): a Galerkin initial guess makes Wᵀ r0 = 0, and projecting the
(preconditioned) residual out of span{W} inside the direction update —
``cg_solve``'s ``project`` hook, the SAME single recurrence as every other
CG driver here — keeps all search directions A-orthogonal to W, so the
invariant Wᵀ r_j = 0 holds in exact arithmetic and the spectrum is clipped.

When it applies (honest scoping, measured): Lanczos-probe deflation needs
the low modes to be ISOLATED — a handful of outlier eigenvalues separated
from the bulk (weak constraints, near-floating regions, density contrast:
Vuik's bubbly-flow pressure systems).  An m-step probe resolves such
outliers essentially exactly (they converge first in Lanczos), and the
iteration count drops to that of the bulk spectrum.  For CLUSTERED low
modes (the plain Poisson ladder) no small probe can span them — that's
multigrid's job (``precond/``); deflation *complements* the V-cycle, it
does not replace it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class Deflation:
    """Deflation space: ``W`` (n, k) Ritz basis, ``AW = A @ W``, and the
    Galerkin matrix ``E = Wᵀ A W`` held in equilibrated form — ``scale`` =
    diag(E)^(-1/2) and ``chol_E`` = chol(scale E scale).

    The equilibration is load-bearing in fp32: E's eigenvalues ARE the Ritz
    values, so deflating a 1e-6 outlier against an O(1) bulk gives
    kappa(E) ~ 1e6 — a raw fp32 Cholesky solve then loses ~5 of 7 digits,
    the Wᵀ r = 0 invariant fails at ~1e-2, and def-CG diverges (measured).
    W is near-A-orthogonal, so E is near-diagonal and the scaled system has
    kappa ~ O(1): the small solve is eps32-accurate again.  (The second
    fp32 hazard — cancellation in computing AW itself — is handled at build
    time: ``make_deflation`` runs the probe columns through the dd SpMV.)"""

    W: jax.Array  # (n, k) — row-sharded inside shard_map (n_local, k)
    AW: jax.Array  # (n, k)
    chol_E: jax.Array  # (k, k) lower-triangular factor of scale·E·scale
    scale: jax.Array  # (k,) = diag(E)^(-1/2)
    psum_axis: Optional[str] = None  # static: set inside shard_map bodies

    @property
    def k(self) -> int:
        return self.W.shape[1]

    def with_axis(self, axis: Optional[str]) -> "Deflation":
        """Shard-local view: with ``psum_axis`` set, the (k,) Galerkin
        coefficient contraction psums over the mesh axis, so every hook
        works unchanged inside ``shard_map`` on row-sharded W/AW (the k x k
        solve is replicated — it is the coarse problem, the analogue of the
        reference's host-side ``resultsDot.Sum()`` scalar stage)."""
        return dataclasses.replace(self, psum_axis=axis)

    # -- the three pieces def-CG needs (all shape-agnostic: vectors may be
    # grid-shaped; the (n, k) contractions flatten internally) --------------

    def _coeffs(self, U, v):
        # full precision: a reduced-precision fp32 matmul (TF32/bf16 passes)
        # is fatal for these (n, k) contractions, whose whole point is
        # resolving ~1e-6-scale deflated components (cf. the AW note in
        # make_deflation); bandwidth-bound, so HIGHEST costs nothing
        c = jnp.matmul(U.T, v.reshape(-1), precision=MATMUL_PRECISION)
        if self.psum_axis is not None:
            c = jax.lax.psum(c, self.psum_axis)
        return self.scale * jax.scipy.linalg.cho_solve(
            (self.chol_E, True), self.scale * c
        )

    def galerkin_correct(self, x, r):
        """x + W E⁻¹ Wᵀ r — the Galerkin (coarse) solve that zeroes Wᵀ r."""
        return x + jnp.matmul(
            self.W, self._coeffs(self.W, r), precision=MATMUL_PRECISION
        ).reshape(x.shape)

    def project_direction(self, z):
        """z - W E⁻¹ (AW)ᵀ z — keeps directions A-orthogonal to span{W}."""
        return z - jnp.matmul(
            self.W, self._coeffs(self.AW, z), precision=MATMUL_PRECISION
        ).reshape(z.shape)

    def project_residual(self, r):
        """r - AW E⁻¹ Wᵀ r — zeroes Wᵀ r exactly (Wᵀ AW = E).  Applied
        every iteration (``cg_solve``'s ``project_r`` hook) this is the
        DEF-form stabilisation: without it the Wᵀ r = 0 invariant drifts at
        O(eps·kappa)/step and fp32 def-CG on an outlier spectrum DIVERGES
        (measured).  The deflated solution components it discards are
        restored by the final Galerkin correction."""
        return r - jnp.matmul(
            self.AW, self._coeffs(self.W, r), precision=MATMUL_PRECISION
        ).reshape(r.shape)


jax.tree_util.register_dataclass(
    Deflation,
    data_fields=["W", "AW", "chol_E", "scale"],
    meta_fields=["psum_axis"],
)


def lanczos_basis(op: Callable, n: int, m: int, dtype=jnp.float32, seed: int = 0):
    """m-step device Lanczos with full reorthogonalisation.

    Returns ``(V, alphas, betas)``: ``V`` is the (m, n) orthonormal Krylov
    basis and the scalars assemble the tridiagonal Rayleigh quotient.  The
    reorthogonalisation is two (m, n) matmuls per step against the masked
    basis — bandwidth-bound matmuls, so "full" costs little at solver scale.  Traceable;
    runs as one jitted ``lax.scan``.
    """
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    V0 = jnp.zeros((m, n), dtype).at[0].set(v0)

    def step(carry, j):
        V, beta_prev, v_prev = carry
        q = V[j]
        w = op(q)
        alpha = jnp.vdot(q, w, precision=MATMUL_PRECISION)
        w = w - alpha * q - beta_prev * v_prev
        # full reorthogonalisation against the rows filled so far (rows past
        # j are zero, so the masked contraction is just the full matmul)
        w = w - jnp.matmul(
            V.T, jnp.matmul(V, w, precision=MATMUL_PRECISION), precision=MATMUL_PRECISION
        )
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), 0.0)
        V = jax.lax.cond(
            j + 1 < m, lambda V: V.at[j + 1].set(v_next), lambda V: V, V
        )
        return (V, beta, q), (alpha, beta)

    (V, _, _), (alphas, betas) = jax.lax.scan(
        step, (V0, jnp.zeros((), dtype), jnp.zeros(n, dtype)), jnp.arange(m)
    )
    return V, alphas, betas


def make_deflation(
    A,
    k: int = 8,
    m: Optional[int] = None,
    dtype=np.float32,
    seed: int = 0,
) -> Deflation:
    """Build a k-dimensional deflation space for operator ``A`` (any
    container, host or device) from an m-step Lanczos probe (default
    ``m = max(4k, 32)``).

    Setup cost: m SpMVs + one (m, m) host eigendecomposition + one (n, m) x
    (m, k) matmul — amortised over every solve in the sequence.  The Ritz
    vectors need not be exact eigenvectors: any subspace aligned with the
    low modes clips the spectrum proportionally.
    """
    m = m or max(4 * k, 32)
    A_dev = A.device_put(dtype) if hasattr(A, "device_put") else A
    n = A_dev.n

    V, alphas, betas = jax.jit(
        lambda A_: lanczos_basis(lambda v: as_operator(A_)(v), n, m, dtype, seed)
    )(A_dev)

    a = np.asarray(alphas, np.float64)
    b_ = np.asarray(betas, np.float64)[:-1]
    T = np.diag(a) + np.diag(b_, 1) + np.diag(b_, -1)
    evals, S = np.linalg.eigh(T)
    Sk = jnp.asarray(S[:, :k], dtype)  # k smallest Ritz pairs

    W = jax.jit(lambda V_, Sk_: jnp.matmul(V_.T, Sk_, precision=MATMUL_PRECISION))(V, Sk)  # (n, k)

    # AW to WORKING accuracy, not fp32-SpMV accuracy: for an outlier mode
    # (lambda ~ 1e-6 against an O(1) bulk) the fp32 A @ w is pure
    # cancellation — measured ~6% relative error on the 1e-3-scaled outlier
    # workload — and def-CG needs the (W, AW, E) triple mutually consistent
    # to ~eps32, or the Wᵀ r = 0 invariant collapses and the solve diverges
    # (measured; equilibration alone did not save it).  When the host fp64
    # container is available, run the probe columns through the dd
    # (two-fp32) SpMV (ops/dd.py): its hi part IS the correctly-rounded
    # fp32 value of A @ w, and hi+lo gives an ~2^-48-accurate E.
    from conjugategradient_tpu.ops import dd as _dd

    ddm = None
    if np.dtype(dtype) == np.float32 and hasattr(A, "device_put"):
        try:
            ddm = _dd.dd_split_matrix(A)
        except TypeError:
            ddm = None  # format without a dd SpMV: fall back to plain fp32

    if ddm is not None:

        @jax.jit
        def _aw_dd(ddm_, W_):
            zero = jnp.zeros_like(W_[:, 0])
            cols = [_dd.dd_spmv(ddm_, (W_[:, j], zero)) for j in range(k)]
            return (
                jnp.stack([c[0] for c in cols], axis=1),
                jnp.stack([c[1] for c in cols], axis=1),
            )

        AW_hi, AW_lo = _aw_dd(ddm, W)
        AW = AW_hi  # canonical pair: hi is the fp32 rounding of the dd value
        AW64 = np.asarray(AW_hi, np.float64) + np.asarray(AW_lo, np.float64)
    else:
        AW = jax.jit(
            lambda A_, W_: jax.vmap(
                lambda col: as_operator(A_)(col),
                in_axes=1, out_axes=1,
            )(W_)
        )(A_dev, W)
        AW64 = np.asarray(AW, np.float64)

    # E, its equilibration, and the Cholesky in host fp64 (k x k — free).
    # E is SPD in exact arithmetic (W orthonormal, A SPD); symmetrise the
    # rounding skew only — NO jitter: perturbing E breaks the Wᵀ r = 0
    # invariant the whole recurrence rests on (measured: a 1e-7-scaled
    # jitter left Wᵀ r0 at 1e-5 and the solve stagnated).
    W64 = np.asarray(W, np.float64)
    E = W64.T @ AW64
    E = 0.5 * (E + E.T)
    dE = np.diag(E)
    if not (np.isfinite(dE).all() and (dE > 0).all()):
        raise ValueError(
            "deflation Galerkin matrix is not positive definite — the Lanczos "
            "probe degenerated (is A symmetric positive definite?)"
        )
    scale = 1.0 / np.sqrt(dE)
    Es = scale[:, None] * E * scale[None, :]
    try:
        L = np.linalg.cholesky(Es)
    except np.linalg.LinAlgError:
        raise ValueError(
            "deflation Galerkin matrix is not positive definite — the Lanczos "
            "probe degenerated (is A symmetric positive definite?)"
        )
    return Deflation(
        W, AW, jnp.asarray(L, dtype), jnp.asarray(scale, dtype)
    )


def deflated_cg_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    deflation: Deflation = None,
    M: Optional[Callable] = None,
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b by def-CG on the deflated spectrum.  Traceable: call
    under ``jit`` with ``deflation`` as a pytree argument.

    The Galerkin initial correction solves the coarse (k x k) problem
    exactly, then CG runs with every direction A-orthogonal to W via the
    ``project`` hook — one shared recurrence with all other drivers.
    """
    if deflation is None:
        raise ValueError("deflated_cg_solve requires deflation=make_deflation(A)")
    op = as_operator(A)
    x_init = jnp.zeros_like(b) if x0 is None else x0.astype(b.dtype)
    r = b - op(x_init)
    x_init = deflation.galerkin_correct(x_init, r)
    res = cg_solve(
        A, b, x_init, policy=policy, M=M, precise_dot=precise_dot,
        project=deflation.project_direction,
        project_r=deflation.project_residual,
    )
    # final Galerkin correction: project_r removed the span{W} residual
    # components from the recurrence; one true residual + coarse solve puts
    # the corresponding solution components back exactly
    x = deflation.galerkin_correct(res.x, b - op(res.x))
    return dataclasses.replace(res, x=x)
