"""Smoothers and simple preconditioners: point Jacobi, weighted Jacobi,
Chebyshev polynomial smoothing.

The only trace of preconditioning in the reference is a commented-out
ViennaCL ``jacobi_precond`` call (``Mgcg/ViennaCL/Mgcg/ComputerGpu.cpp:96-101``)
— here Jacobi is implemented for real, plus Chebyshev, which is the natural
device smoother: it is built entirely from SpMV + axpy (no triangular solves, no
data-dependent ordering like Gauss-Seidel), so every application is the same
fused streaming program the rest of the framework already optimises.

Everything here is traceable (pure jnp on static shapes) and row-shard
equivariant when the operator is (pointwise scaling + SpMV), so the same
smoothers serve the single-chip and ``shard_map`` paths.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp

Operator = Callable[[jnp.ndarray], jnp.ndarray]


def jacobi_preconditioner(inv_diag: jnp.ndarray) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Point-Jacobi M^{-1} r = D^{-1} r — the preconditioner ViennaCL left
    commented out, as one multiply."""
    return lambda r: inv_diag * r


def jacobi_smooth(
    op: Operator,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    iters: int,
    omega: float = 2.0 / 3.0,
) -> jnp.ndarray:
    """``iters`` sweeps of weighted Jacobi: x += omega D^{-1} (b - A x).

    Statically unrolled — iters is small (1-4) and unrolling lets XLA fuse the
    residual update into the SpMV epilogue.
    """
    for _ in range(iters):
        x = x + omega * (inv_diag * (b - op(x)))
    return x


def chebyshev_smooth(
    op: Operator,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    degree: int,
    lam_max: float,
    lam_min: float,
) -> jnp.ndarray:
    """Chebyshev polynomial smoothing of the Jacobi-scaled system.

    Damps error components with D^{-1}A-eigenvalues in [lam_min, lam_max]
    optimally for a fixed ``degree`` (matrix-poly in D^{-1}A of that degree).
    The classic three-term recurrence; all scalars are static python floats,
    so the whole smoother compiles to ``degree`` SpMVs plus fused axpys.

    Bounds come from ``solvers.eigen`` (power iteration / Gershgorin) at
    hierarchy-setup time.
    """
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = inv_diag * (b - op(x))
    d = r / theta
    for _ in range(degree):
        x = x + d
        r = r - inv_diag * op(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def chebyshev_preconditioner(
    op: Operator,
    inv_diag: jnp.ndarray,
    degree: int,
    lam_min: float,
    lam_max: float,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Fixed-degree Chebyshev polynomial preconditioner M r = p(D⁻¹A) D⁻¹ r.

    For matrices with no grid structure to hang a multigrid hierarchy on
    (and where point Jacobi is too weak), a fixed matrix polynomial is the
    device-natural middle ground: each application is ``degree`` SpMVs + fused
    axpys — no triangular solves, no data-dependent ordering — and, unlike a
    tolerance-controlled inner solve, it is a FIXED linear SPD operator, so
    plain (non-flexible) CG theory applies.  Bounds must cover the whole
    spectrum of D⁻¹A (use ``solvers.eigen.lanczos_bounds`` / Gershgorin at
    setup), unlike the smoothing interval [lam_max/4, lam_max] used inside
    multigrid.

    Row-shard equivariant whenever ``op`` is (pass a halo-exchange SpMV to
    use it inside ``shard_map`` loops).
    """
    if not (0.0 < lam_min < lam_max):
        raise ValueError(f"need 0 < lam_min < lam_max, got [{lam_min}, {lam_max}]")

    def M(r):
        return chebyshev_smooth(op, inv_diag, r, jnp.zeros_like(r), degree, lam_max, lam_min)

    return M


def chebyshev_preconditioner_for(A, degree: int = 3, k: int = 30, A_dev=None, dtype=None):
    """Host-side convenience: estimate spec(D⁻¹A) bounds by Lanczos and
    return ``(M, (lam_min, lam_max))`` for the device operator of ``A``.

    The bounds come from Lanczos on the SYMMETRIC similar operator
    ``v -> D^{-1/2} A D^{-1/2} v`` (same spectrum as D⁻¹A; Euclidean Lanczos
    on the non-symmetric D⁻¹A itself would silently discard its
    upper-Hessenberg part and can misestimate the interval — fatal here,
    since the Chebyshev polynomial explodes outside it).

    ``A_dev``/``dtype`` let callers that already placed the matrix reuse it
    (one device copy, preconditioner applied at the solver's dtype)."""
    import numpy as np

    from conjugategradient_tpu.core import oracle
    from conjugategradient_tpu.core.formats import matrix_diagonal
    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.solvers import eigen

    d = matrix_diagonal(A)
    if np.any(d <= 0):
        raise ValueError("Chebyshev preconditioning needs a positive diagonal")
    d_isqrt = 1.0 / np.sqrt(d)
    lo, hi = eigen.lanczos_bounds(
        lambda v: d_isqrt * oracle.spmv(A, d_isqrt * v), A.n, k
    )
    if not (lo > 0):  # Lanczos underestimate hit zero: fall back to a floor
        lo = max(lo, 1e-3 * hi)
    lo, hi = 0.9 * lo, 1.1 * hi  # Ritz values are interior: widen slightly
    if A_dev is None:
        A_dev = A.device_put(dtype=dtype) if dtype is not None else A.device_put()
    dt = dtype or np.asarray(A_dev.data).dtype
    inv_d = jnp.asarray(1.0 / d, dtype=dt)
    return chebyshev_preconditioner(as_operator(A_dev), inv_d, degree, lo, hi), (lo, hi)


def parity_mask(grid) -> jnp.ndarray:
    """Checkerboard mask over a tensor grid: True where sum(indices) is even."""
    import numpy as np

    idx = np.indices(grid).sum(axis=0)
    return jnp.asarray(idx % 2 == 0)


def redblack_gs_smooth(
    op: Operator,
    inv_diag: jnp.ndarray,
    b: jnp.ndarray,
    x: jnp.ndarray,
    iters: int,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Red-black Gauss-Seidel: the classic strong smoother, in its
    two-color (fully data-parallel) form.

    Each half-sweep updates one checkerboard color with the *latest* values of
    the other — exact Gauss-Seidel ordering for 2-colorable stencils (5/7
    -point Poisson); for wider stencils (e.g. 9-point Galerkin coarse
    operators, where diagonal neighbours share a color) it degrades gracefully
    into a hybrid block sweep that still smooths well.  Each half-sweep costs
    one full stencil apply — the price of exposing all the parallelism, and
    the reason Gauss-Seidel's serial "natural ordering" has no place on a
    2-D-vector machine.

    Symmetric by sweep reversal: pre-smoothing runs red->black, and callers
    wanting a symmetric V-cycle should post-smooth black->red (see
    ``multigrid._smooth``).
    """
    for _ in range(iters):
        x = jnp.where(mask, x + inv_diag * (b - op(x)), x)
        x = jnp.where(mask, x, x + inv_diag * (b - op(x)))
    return x


def redblack_gs_smooth_reversed(op, inv_diag, b, x, iters, mask):
    """Black->red sweeps — the adjoint ordering, for symmetric post-smoothing."""
    for _ in range(iters):
        x = jnp.where(mask, x, x + inv_diag * (b - op(x)))
        x = jnp.where(mask, x + inv_diag * (b - op(x)), x)
    return x
