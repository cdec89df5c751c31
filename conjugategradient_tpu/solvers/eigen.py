"""Eigenvalue diagnostics: Jacobi rotations, power iteration, Lanczos bounds,
Gershgorin estimates.

The reference ships a classical Jacobi-rotation eigenvalue solver inside its
ELL matrix class (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:234-372``: densify,
find max off-diagonal, apply Givens rotations until the off-diagonal norm
drops below tolerance) and left eigen/condition-number probes commented in the
R prototype (``R/CG.R:26-27``).  Those diagnostics are first-class here —
they also *drive* the solver stack: Chebyshev smoothing needs spectral bounds
of the Jacobi-scaled operator, and kappa(A) predicts CG iteration counts.

Device paths are fully traceable (``lax.while_loop`` / ``fori_loop``); host
paths are cheap numpy for setup-time use.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.core import oracle
from conjugategradient_tpu.core.formats import DenseMatrix, DiaMatrix
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def jacobi_eigenvalues(
    A, tol: float = 1e-10, max_sweeps: int = 100
) -> jnp.ndarray:
    """All eigenvalues of a small symmetric matrix by cyclic Jacobi rotations.

    Device re-design of the reference's classical (max-pivot) Jacobi solver
    (``SparseMatrix.cs:284-350``): instead of its serial find-max + one
    rotation per step, each sweep applies a full cyclic pass of (p, q)
    rotations — the same O(n^2)-rotation convergence with compiler-friendly
    static control flow.  Intended for diagnostics on small/coarse matrices
    (n <= a few hundred), like the reference's use.

    Returns the eigenvalues, sorted ascending.
    """
    if isinstance(A, DiaMatrix):
        from conjugategradient_tpu.core.formats import dia_to_dense

        A = dia_to_dense(A)
    if isinstance(A, DenseMatrix):
        A = A.data
    A = jnp.asarray(A)
    n = A.shape[0]
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    pq = jnp.asarray(pairs, dtype=jnp.int32)

    def rotate(M, pq_row):
        p, q = pq_row[0], pq_row[1]
        apq = M[p, q]
        app = M[p, p]
        aqq = M[q, q]
        # Stable rotation angle: theta = (aqq - app) / (2 apq).
        theta = (aqq - app) / (2.0 * jnp.where(apq == 0, 1.0, apq))
        t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
        t = jnp.where(apq == 0, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1.0)
        s = t * c
        rot_p = c * M[p, :] - s * M[q, :]
        rot_q = s * M[p, :] + c * M[q, :]
        M = M.at[p, :].set(rot_p).at[q, :].set(rot_q)
        col_p = c * M[:, p] - s * M[:, q]
        col_q = s * M[:, p] + c * M[:, q]
        M = M.at[:, p].set(col_p).at[:, q].set(col_q)
        return M, None

    def sweep(M):
        M, _ = jax.lax.scan(rotate, M, pq)
        return M

    def off_norm(M):
        return jnp.sqrt(jnp.sum(M * M) - jnp.sum(jnp.diag(M) ** 2))

    def cond(state):
        M, it = state
        return jnp.logical_and(off_norm(M) > tol, it < max_sweeps)

    def body(state):
        M, it = state
        return sweep(M), it + 1

    M, _ = jax.lax.while_loop(cond, body, (A, jnp.int32(0)))
    return jnp.sort(jnp.diag(M))


def power_iteration(
    op: Callable[[jnp.ndarray], jnp.ndarray],
    n: int,
    iters: int = 30,
    seed: int = 0,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Largest eigenvalue of a symmetric PSD operator, on device."""
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, carry):
        v, lam = carry
        w = op(v)
        lam = jnp.dot(w, v, precision=MATMUL_PRECISION, preferred_element_type=w.dtype)
        nw = jnp.linalg.norm(w)
        return (w / jnp.where(nw == 0, 1.0, nw), lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v0, jnp.zeros((), dtype)))
    return lam


def power_iteration_host(apply, n: int, iters: int = 30, seed: int = 0) -> float:
    """numpy power iteration for setup-time bounds (no device round trips)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = apply(v)
        lam = float(w @ v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 0.0
        v = w / nw
    return lam


def lanczos_bounds(apply, n: int, k: int = 20, seed: int = 0) -> Tuple[float, float]:
    """(lambda_min, lambda_max) estimates of a symmetric operator via k-step
    Lanczos (host numpy, full reorthogonalisation — k is small)."""
    rng = np.random.default_rng(seed)
    k = min(k, n)
    Q = np.zeros((n, k + 1))
    alpha = np.zeros(k)
    beta = np.zeros(k + 1)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    Q[:, 0] = q
    for j in range(k):
        w = apply(Q[:, j])
        alpha[j] = Q[:, j] @ w
        w -= alpha[j] * Q[:, j]
        if j > 0:
            w -= beta[j] * Q[:, j - 1]
        w -= Q[:, : j + 1] @ (Q[:, : j + 1].T @ w)  # reorthogonalise
        beta[j + 1] = np.linalg.norm(w)
        if beta[j + 1] < 1e-14:
            k = j + 1
            break
        Q[:, j + 1] = w / beta[j + 1]
    T = np.diag(alpha[:k]) + np.diag(beta[1:k], 1) + np.diag(beta[1:k], -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def gershgorin_bounds(A: DiaMatrix) -> Tuple[float, float]:
    """Cheap inclusion bounds from the DIA data: for each row,
    [a_ii - R_i, a_ii + R_i] with R_i the off-diagonal absolute row sum."""
    data = np.asarray(A.data)
    if 0 in A.offsets:
        diag = data[A.offsets.index(0)]
    else:
        diag = np.zeros(A.n, dtype=data.dtype)
    radius = np.abs(data).sum(axis=0) - np.abs(diag)
    return float((diag - radius).min()), float((diag + radius).max())


def scaled_spectrum_bounds(
    A: DiaMatrix, iters: int = 30, lower_frac: float = 0.25
) -> Tuple[float, float]:
    """Smoothing-interval bounds on spec(D^{-1}A) for Chebyshev setup.

    Upper bound: host power iteration on D^{-1}A with a 10% safety margin.
    Lower bound: ``lower_frac * lam_max`` — the classic multigrid smoothing
    interval [lam_max/4, lam_max]: the smoother owns the upper spectrum, the
    coarse-grid correction owns the rest.  (A degree-3 sweep on [l/4, l]
    damps every mode in the interval below ~0.08; stretching the interval to
    [l/30, l] would cap damping at ~0.6.)
    """
    inv_d = 1.0 / _dia_diag(A)
    lam_max = power_iteration_host(lambda v: inv_d * oracle.spmv(A, v), A.n, iters)
    lam_max *= 1.1
    return lower_frac * lam_max, lam_max


def _dia_diag(A: DiaMatrix) -> np.ndarray:
    from conjugategradient_tpu.core.formats import dia_diagonal

    d = dia_diagonal(A)
    if np.any(d == 0):
        raise ValueError("matrix has zero diagonal entries; cannot Jacobi-scale")
    return d


def condition_number(A, k: int = 30) -> float:
    """kappa_2(A) estimate via Lanczos — the R prototype's commented-out
    ``kappa(A)`` probe (``R/CG.R:27``), usable at scale."""
    apply = lambda v: oracle.spmv(A, v) if not isinstance(A, DenseMatrix) else np.asarray(A.data) @ v
    lo, hi = lanczos_bounds(apply, A.n, k)
    if lo <= 0:
        return float("inf")
    return hi / lo


def spectrum_from_cg(alphas, betas, iterations: int):
    """Extremal eigenvalues + condition number of the (preconditioned)
    operator from a CG run's own scalars — spectral diagnostics for free.

    A CG solve is a Lanczos process on M⁻¹A in disguise: its step scalars
    assemble the Lanczos tridiagonal (Saad, *Iterative Methods*, §6.7.3)

        T[j, j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}   (beta_{-1} = 0)
        T[j, j+1] = sqrt(beta_j)/alpha_j

    whose eigenvalues (Ritz values) converge to the extremal spectrum of
    M⁻¹A as the iteration proceeds.  Feed it the ``(alphas, betas)`` that
    ``cg_solve_traced(..., with_coefficients=True)`` records and the
    result's ``iterations``; this turns every traced solve into the probe
    the reference kept commented out in R (``R/CG.R:26-27``) and the
    diagnostic its Jacobi eigensolver served (``SparseMatrix.cs:234-372``)
    — at zero extra matrix passes, and *through the preconditioner*: for
    MGCG it measures kappa(M⁻¹A), i.e. how good the V-cycle actually is.

    Returns ``(lam_min, lam_max, kappa)`` — estimates are interior to the
    true spectrum (Ritz values underestimate kappa slightly until
    convergence).  Needs ``iterations >= 1``; host-side fp64 numpy.
    """
    m = int(iterations)
    if m < 1:
        raise ValueError("spectrum_from_cg needs at least one CG iteration")
    a = np.asarray(alphas, dtype=np.float64)[:m]
    b = np.asarray(betas, dtype=np.float64)[:m]
    if np.any(a == 0):
        # frozen/exact-convergence steps inside the window: trim at first 0
        m = int(np.argmax(a == 0))
        if m < 1:
            raise ValueError("no usable CG coefficients (alpha[0] == 0)")
        a, b = a[:m], b[:m]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    try:
        from scipy.linalg import eigh_tridiagonal

        w = eigh_tridiagonal(diag, off, eigvals_only=True)
    except ImportError:  # pragma: no cover
        T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
        w = np.linalg.eigvalsh(T)
    lam_min, lam_max = float(w[0]), float(w[-1])
    kappa = lam_max / lam_min if lam_min > 0 else float("inf")
    return lam_min, lam_max, kappa
