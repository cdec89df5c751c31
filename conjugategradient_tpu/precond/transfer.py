"""Grid-transfer operators: full-weighting restriction / linear prolongation.

New capability (SURVEY.md §7 layer 5): the reference's "Mgcg" name promises
multigrid (マルチグリッド前処理付き共役勾配法, ``Mgcg/cuBlas/Mgcg/MgcgMain.cs:8``)
but implements none — these operators are designed fresh for the device.

Geometry: a d-dimensional tensor grid of *interior* points (Dirichlet), each
axis of odd size ``n = 2m + 1``; the coarse axis keeps the ``m`` odd-indexed
points.  1-D stencils (the classics):

- prolongation ``P``: ``ef[2j+1] = ec[j]``, ``ef[2j] = (ec[j-1] + ec[j])/2``
  (boundary neighbours are zero),
- restriction ``R = P^T / 2`` per axis: ``rc[j] = (rf[2j] + 2 rf[2j+1] + rf[2j+2]) / 4``.

d-dimensional operators are the per-axis tensor (Kronecker) products, applied
axis-by-axis on the device as *static strided slices* — pure streaming, no
gathers, fully fused by XLA.  The same operators are assembled as scipy
sparse matrices host-side for the Galerkin coarse-operator product
(``coarse.py``), guaranteeing the device transfers and the coarse operators
are exact transposes of each other (which is what keeps the V-cycle symmetric
and hence a valid PCG preconditioner).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import scipy.sparse as sp

GridShape = Tuple[int, ...]


def coarse_shape(fine: GridShape) -> GridShape:
    """Coarse grid shape; every axis must be odd and >= 3."""
    for n in fine:
        if n < 3 or n % 2 == 0:
            raise ValueError(f"axis size {n} not coarsenable (need odd >= 3); shape={fine}")
    return tuple((n - 1) // 2 for n in fine)


def can_coarsen(fine: GridShape) -> bool:
    return all(n >= 3 and n % 2 == 1 for n in fine)


def _restrict_axis(v: jnp.ndarray) -> jnp.ndarray:
    """Full weighting along the last axis (odd size n -> (n-1)//2)."""
    n = v.shape[-1]
    return 0.25 * v[..., 0 : n - 2 : 2] + 0.5 * v[..., 1 : n - 1 : 2] + 0.25 * v[..., 2:n:2]


def _prolong_axis(e: jnp.ndarray, n_fine: int) -> jnp.ndarray:
    """Linear interpolation along the last axis ((n-1)//2 -> n)."""
    pad = [(0, 0)] * (e.ndim - 1) + [(1, 1)]
    ep = jnp.pad(e, pad)
    even = 0.5 * (ep[..., :-1] + ep[..., 1:])  # length m+1, values at fine 0,2,...,2m
    out = jnp.zeros(e.shape[:-1] + (n_fine,), e.dtype)
    out = out.at[..., 1::2].set(e)
    out = out.at[..., 0::2].set(even)
    return out


def restrict_grid(v: jnp.ndarray) -> jnp.ndarray:
    """Grid-shaped full-weighting restriction along every axis."""
    for ax in range(v.ndim):
        v = jnp.moveaxis(_restrict_axis(jnp.moveaxis(v, ax, -1)), -1, ax)
    return v


def prolong_grid(v: jnp.ndarray, fine: GridShape) -> jnp.ndarray:
    """Grid-shaped linear prolongation up to ``fine``."""
    for ax in range(len(fine)):
        v = jnp.moveaxis(_prolong_axis(jnp.moveaxis(v, ax, -1), fine[ax]), -1, ax)
    return v


def restrict(r: jnp.ndarray, fine: GridShape) -> jnp.ndarray:
    """Restrict a flat residual vector from ``fine`` to ``coarse_shape(fine)``."""
    return restrict_grid(r.reshape(fine)).reshape(-1)


def prolong(e: jnp.ndarray, fine: GridShape) -> jnp.ndarray:
    """Prolong a flat coarse correction up to the flat ``fine`` grid."""
    return prolong_grid(e.reshape(coarse_shape(fine)), fine).reshape(-1)


# ---------------------------------------------------------------------------
# Aggregation transfers — coarsening for ARBITRARY axis sizes.
#
# Full weighting needs odd axes (vertex-centered halving); real workloads come
# in any size (the reference's tridiagonal demo is exactly 2^16).  Pairwise
# aggregation has no size constraint: coarse cell j owns fine cells
# {2j, 2j+1} (the last cell owns a single fine cell when the axis is odd),
# P = piecewise-constant injection, R = P^T / 2 per axis.  Convergence per
# cycle is weaker than full weighting, but wrapped in CG it stays mesh
# -independent — and it upgrades "multigrid for 2^k-1 grids" into
# "multigrid for every workload".
# ---------------------------------------------------------------------------


def agg_coarse_shape(fine: GridShape) -> GridShape:
    for n in fine:
        if n < 2:
            raise ValueError(f"axis size {n} not aggregatable; shape={fine}")
    return tuple((n + 1) // 2 for n in fine)


def can_aggregate(fine: GridShape) -> bool:
    return all(n >= 2 for n in fine)


def _restrict_agg_axis(v: jnp.ndarray) -> jnp.ndarray:
    m = v.shape[-1]
    if m % 2:
        pad = [(0, 0)] * (v.ndim - 1) + [(0, 1)]
        v = jnp.pad(v, pad)
    shaped = v.reshape(v.shape[:-1] + (-1, 2))
    return 0.5 * (shaped[..., 0] + shaped[..., 1])


def _prolong_agg_axis(e: jnp.ndarray, n_fine: int) -> jnp.ndarray:
    out = jnp.repeat(e, 2, axis=-1)
    return out[..., :n_fine]


def restrict_agg_grid(v: jnp.ndarray) -> jnp.ndarray:
    for ax in range(v.ndim):
        v = jnp.moveaxis(_restrict_agg_axis(jnp.moveaxis(v, ax, -1)), -1, ax)
    return v


def prolong_agg_grid(v: jnp.ndarray, fine: GridShape) -> jnp.ndarray:
    for ax in range(len(fine)):
        v = jnp.moveaxis(_prolong_agg_axis(jnp.moveaxis(v, ax, -1), fine[ax]), -1, ax)
    return v


def prolong_agg_matrix_1d(n_fine: int) -> sp.csr_matrix:
    m = (n_fine + 1) // 2
    rows = list(range(n_fine))
    cols = [j // 2 for j in rows]
    vals = [1.0] * n_fine
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_agg_matrix(fine: GridShape) -> sp.csr_matrix:
    P = prolong_agg_matrix_1d(fine[0])
    for n in fine[1:]:
        P = sp.kron(P, prolong_agg_matrix_1d(n), format="csr")
    return P


# ---------------------------------------------------------------------------
# Host-side (scipy) assembly — for the Galerkin product R A P.
# ---------------------------------------------------------------------------


def prolong_matrix_1d(n_fine: int) -> sp.csr_matrix:
    """The 1-D P as a (n_fine, m) sparse matrix."""
    m = (n_fine - 1) // 2
    rows, cols, vals = [], [], []
    for j in range(m):
        rows += [2 * j, 2 * j + 1, 2 * j + 2]
        cols += [j, j, j]
        vals += [0.5, 1.0, 0.5]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_matrix(fine: GridShape) -> sp.csr_matrix:
    """d-D P as the Kronecker product over axes (row-major vector ordering:
    axis 0 is outermost, matching ``reshape(fine)``)."""
    P = prolong_matrix_1d(fine[0])
    for n in fine[1:]:
        P = sp.kron(P, prolong_matrix_1d(n), format="csr")
    return P


def restrict_matrix(fine: GridShape) -> sp.csr_matrix:
    """R = P^T / 2^d (full weighting)."""
    return (prolong_matrix(fine).T * (0.5 ** len(fine))).tocsr()


# ---------------------------------------------------------------------------
# Hybrid per-axis transfers — full weighting on odd axes, CELL-CENTERED
# linear interpolation on even axes.
#
# Plain pairwise aggregation (above) coarsens any size but converges ~2x
# slower than interpolating transfers (measured: 7-9 MGCG its vs 4 on the
# Poisson family).  Even axes cannot use vertex-centered full weighting, but
# the cell-centered P
#
#     ef[2J]   = (3 ec[J] + ec[J-1]) / 4
#     ef[2J+1] = (3 ec[J] + ec[J+1]) / 4        (missing neighbours dropped)
#
# interpolates linearly between cell centers, needs only even extents, and —
# critically for the distributed probed setup — keeps Galerkin coarse
# stencils at extent <= 1 (unlike SA smoothing, which widens by a ring per
# level).  R = P^T / 2 per axis, as everywhere else.
# ---------------------------------------------------------------------------


def hybrid_kinds(fine: GridShape):
    """Per-axis transfer choice ("fw" | "cc"), or None if some axis cannot
    coarsen (odd axes need >= 3, even axes >= 2)."""
    kinds = []
    for n in fine:
        if n % 2 == 1 and n >= 3:
            kinds.append("fw")
        elif n % 2 == 0 and n >= 2:
            kinds.append("cc")
        else:
            return None
    return tuple(kinds)


def can_hybrid(fine: GridShape) -> bool:
    return hybrid_kinds(fine) is not None


def hybrid_coarse_shape(fine: GridShape) -> GridShape:
    kinds = hybrid_kinds(fine)
    if kinds is None:
        raise ValueError(f"shape {fine} not hybrid-coarsenable")
    return tuple((n - 1) // 2 if k == "fw" else n // 2 for n, k in zip(fine, kinds))


def _restrict_cc_axis(v: jnp.ndarray) -> jnp.ndarray:
    """R = P_cc^T / 2 along the last axis (even size n = 2m -> m):
    rc[J] = (3 v[2J] + 3 v[2J+1] + v[2J-1] + v[2J+2]) / 8."""
    n = v.shape[-1]
    m = n // 2
    a = v[..., 0:n:2]
    b = v[..., 1:n:2]
    pad1 = [(0, 0)] * (v.ndim - 1)
    lft = jnp.pad(v[..., 1 : 2 * m - 2 : 2], pad1 + [(1, 0)]) if m > 1 else jnp.zeros_like(a)
    rgt = jnp.pad(v[..., 2:n:2], pad1 + [(0, 1)]) if m > 1 else jnp.zeros_like(a)
    return (3.0 * (a + b) + lft + rgt) / 8.0


def _prolong_cc_axis(e: jnp.ndarray, n_fine: int) -> jnp.ndarray:
    """P_cc along the last axis (m -> 2m)."""
    pad1 = [(0, 0)] * (e.ndim - 1)
    left = jnp.pad(e[..., :-1], pad1 + [(1, 0)])
    right = jnp.pad(e[..., 1:], pad1 + [(0, 1)])
    even = (3.0 * e + left) / 4.0
    odd = (3.0 * e + right) / 4.0
    out = jnp.stack([even, odd], axis=-1).reshape(e.shape[:-1] + (n_fine,))
    return out


def restrict_hybrid_grid(v: jnp.ndarray) -> jnp.ndarray:
    kinds = hybrid_kinds(v.shape)
    for ax, k in enumerate(kinds):
        fn = _restrict_axis if k == "fw" else _restrict_cc_axis
        v = jnp.moveaxis(fn(jnp.moveaxis(v, ax, -1)), -1, ax)
    return v


def prolong_hybrid_grid(e: jnp.ndarray, fine: GridShape) -> jnp.ndarray:
    kinds = hybrid_kinds(fine)
    for ax, k in enumerate(kinds):
        fn = _prolong_axis if k == "fw" else _prolong_cc_axis
        e = jnp.moveaxis(fn(jnp.moveaxis(e, ax, -1), fine[ax]), -1, ax)
    return e


def prolong_cc_matrix_1d(n_fine: int) -> sp.csr_matrix:
    m = n_fine // 2
    rows, cols, vals = [], [], []
    for J in range(m):
        rows.append(2 * J); cols.append(J); vals.append(0.75)
        if J >= 1:
            rows.append(2 * J); cols.append(J - 1); vals.append(0.25)
        rows.append(2 * J + 1); cols.append(J); vals.append(0.75)
        if J + 1 < m:
            rows.append(2 * J + 1); cols.append(J + 1); vals.append(0.25)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_hybrid_matrix(fine: GridShape) -> sp.csr_matrix:
    """Mixed per-axis P as the Kronecker product (host Galerkin twin of the
    device operators above — exact transposes keep the V-cycle symmetric)."""
    kinds = hybrid_kinds(fine)
    mats = [
        prolong_matrix_1d(n) if k == "fw" else prolong_cc_matrix_1d(n)
        for n, k in zip(fine, kinds)
    ]
    P = mats[0]
    for M in mats[1:]:
        P = sp.kron(P, M, format="csr")
    return P


# ---------------------------------------------------------------------------
# Partial (SEMI-)coarsening — coarsen only a chosen subset of axes.
#
# The anisotropic-diffusion fix: with a point smoother, error after
# relaxation is smooth only along STRONGLY-coupled axes, so full coarsening
# loses the approximation property as anisotropy grows — measured on
# 127x127 at coefficient ratio 1:1/0.1/0.01/0.001 the MGCG iteration count
# climbs 6 / 15 / 47 / 130.  Coarsening just the strong axes (classic
# semicoarsening; Trottenberg et al. §5.1) restores O(1) iterations and is
# trivial on the device: the transfers are the SAME per-axis operators applied to a
# subset of axes (identity on the rest), still one Kronecker product on the
# host side.  Each coarsened axis picks fw (odd) or cc (even) by parity,
# exactly like the hybrid transfers.
# ---------------------------------------------------------------------------


def partial_kinds(fine: GridShape, mask):
    """Per-axis choice ("fw" | "cc" | "id"); None if some MASKED axis
    cannot coarsen."""
    kinds = []
    for n, m in zip(fine, mask):
        if not m:
            kinds.append("id")
        elif n % 2 == 1 and n >= 3:
            kinds.append("fw")
        elif n % 2 == 0 and n >= 2:
            kinds.append("cc")
        else:
            return None
    return tuple(kinds)


def can_partial(fine: GridShape, mask) -> bool:
    return any(mask) and partial_kinds(fine, mask) is not None


def partial_coarse_shape(fine: GridShape, mask) -> GridShape:
    kinds = partial_kinds(fine, mask)
    if kinds is None:
        raise ValueError(f"shape {fine} not partial-coarsenable on {mask}")
    return tuple(
        n if k == "id" else ((n - 1) // 2 if k == "fw" else n // 2)
        for n, k in zip(fine, kinds)
    )


def restrict_partial_grid(v: jnp.ndarray, mask) -> jnp.ndarray:
    kinds = partial_kinds(v.shape, mask)
    for ax, k in enumerate(kinds):
        if k == "id":
            continue
        fn = _restrict_axis if k == "fw" else _restrict_cc_axis
        v = jnp.moveaxis(fn(jnp.moveaxis(v, ax, -1)), -1, ax)
    return v


def prolong_partial_grid(e: jnp.ndarray, fine: GridShape, mask) -> jnp.ndarray:
    kinds = partial_kinds(fine, mask)
    for ax, k in enumerate(kinds):
        if k == "id":
            continue
        fn = _prolong_axis if k == "fw" else _prolong_cc_axis
        e = jnp.moveaxis(fn(jnp.moveaxis(e, ax, -1), fine[ax]), -1, ax)
    return e


def prolong_partial_matrix(fine: GridShape, mask) -> sp.csr_matrix:
    """Mixed per-axis P with identity on uncoarsened axes (host Galerkin
    twin; R = P^T / 2^(#coarsened) keeps the V-cycle symmetric)."""
    kinds = partial_kinds(fine, mask)
    mats = []
    for n, k in zip(fine, kinds):
        if k == "id":
            mats.append(sp.identity(n, format="csr"))
        elif k == "fw":
            mats.append(prolong_matrix_1d(n))
        else:
            mats.append(prolong_cc_matrix_1d(n))
    P = mats[0]
    for M in mats[1:]:
        P = sp.kron(P, M, format="csr")
    return P.tocsr()
