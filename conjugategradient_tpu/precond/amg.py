"""Algebraic multigrid (smoothed aggregation) for unstructured CSR matrices.

``precond.multigrid`` is geometric: it needs a tensor ``grid`` to hang its
stencil hierarchy on.  Matrices that arrive without one — Matrix Market files
(``core/io.py``), permuted/renumbered meshes, graph Laplacians — previously
had only point-/block-Jacobi and Chebyshev polynomials.  This module closes
that gap with classical smoothed aggregation (Vaněk/Mandel/Brezina):

- **Setup on host** (numpy/scipy, like ``build_hierarchy``'s Galerkin
  products): strength-of-connection filter, greedy aggregation over the
  strength graph, near-null-candidate tentative prolongator, Jacobi-smoothed
  ``P = (I - 4/(3 lam_max) D^{-1}A) P0``, Galerkin ``A_c = P^T A P``.
- **Cycle on device**: every level is a ``CsrMatrix`` pytree; the V-cycle is
  segment-sum SpMVs (``ops.spmv.spmv_csr``) + the same Jacobi/Chebyshev
  smoothers the geometric hierarchy uses; the coarsest level is a dense
  matvec.  The whole preconditioner jits and passes through ``jit`` as an
  ARGUMENT (registered pytrees — never a closure constant).

Reference parity: the reference has no preconditioner at all (SURVEY.md §0
naming caveat — "Mgcg" promises one, ``Mgcg/cuBlas/Mgcg/MgcgMain.cs:8``);
this is new capability, the algebraic twin of ``precond/multigrid.py``,
built so ``R = P^T`` keeps the hierarchy SPD (valid as a CG preconditioner,
same argument as ``multigrid._level_transfers``).

Setup cost: the greedy aggregation is a Python loop over rows (O(n) with a
small constant); fine for setup — the reference also assembles on the host —
but for grid-structured systems at scale prefer ``build_hierarchy`` /
``build_hierarchy_probed``, which stay vectorized end to end.  Scope: SPD
with the default Chebyshev smoother; nonsymmetric systems work as RIGHT
preconditioning (``amg_bicgstab``/``amg_gmres``) with ``smoother="jacobi"``
and the hierarchy built on A itself — measured on 63x63 upwind
convection-diffusion (eps=0.1): 660 plain BiCGStab its -> 12 with
(A, jacobi), vs 221 for a symmetric-part hierarchy (the coarse correction
must see the convection) and DIVERGENCE for (A, chebyshev) (Chebyshev
smoothing assumes a real positive D^{-1}A spectrum).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from conjugategradient_tpu.core.formats import CsrMatrix
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
from conjugategradient_tpu.ops.spmv import spmv, spmv_csr
from conjugategradient_tpu.precond.smoothers import chebyshev_smooth, jacobi_smooth

#: smoothed-aggregation prolongator damping: c = _SA_W / lam_max(D^{-1}A)
_SA_W = 4.0 / 3.0


# ---------------------------------------------------------------------------
# containers (registered pytrees: static shapes/bounds as metadata)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AmgLevel:
    """One algebraic level: operator, transfers, smoother data.

    ``agg``/``w``/``nc``/``sa_c`` (when set) carry the COMPOSITION form of
    the transfers: ``P = (I - sa_c D^{-1}A) P0`` with ``(P0 e)[i] =
    w[i] * e[agg[i]]`` — one entry per row.  Applying P/R through that
    factorization replaces the explicit CSR transfer's ~stencil-width
    gathers per row with ONE small-vector gather (P) / one segment-sum
    (R) plus a reuse of the (relayouted, fast) level operator (see
    ``amg_vcycle``).  Only stored when exact:
    unsmoothed P, or smoothed P over a (host-verified) symmetric A, since
    ``R = P^T`` needs ``A^T = A`` to reuse the forward operator.
    """

    A: object  # (n, n) this level's operator: DiaMatrix when bandable, else CsrMatrix
    P: CsrMatrix  # (n, nc) smoothed prolongator
    R: CsrMatrix  # (nc, n) restriction = P^T (SPD-preserving Galerkin)
    inv_diag: jnp.ndarray  # (n,) 1/diag(A)
    cheb_bounds: Tuple[float, float]  # smoothing interval on spec(D^{-1}A)
    agg: Optional[jnp.ndarray] = None  # (n,) int32 aggregate id per row
    w: Optional[jnp.ndarray] = None  # (n,) tentative-prolongator weights
    nc: int = 0  # next level's size (static; segment count for R)
    sa_c: float = 0.0  # smoothing coefficient _SA_W / lam_max (0 = plain P0)
    blk: int = 0  # >0: CONTIGUOUS aggregation (agg[i] == i // blk) — the
    # transfers then lower to a reshape-sum (restrict) and a broadcast-
    # reshape (prolong): ZERO gathers/scatters — gathers and scatters, not
    # SpMVs, dominate a CSR-transfer AMG cycle.
    blk_nd: Optional[tuple] = None  # ((grid), (block)): N-D CONTIGUOUS
    # aggregation over a grid INFERRED from the banded offset structure
    # (``_infer_grid``).  Same zero-gather reshape-sum/broadcast transfers
    # as ``blk``, but with cube-shaped aggregates: edge-3 blocks keep the
    # Galerkin stencil INVARIANT down the hierarchy (measured at 511^2:
    # ndiags 5 -> 9 -> 9 -> 9 vs the 1-D strips' 5 -> 17 -> 53 -> 161 ->
    # 325 explosion) and match greedy's iteration counts (7 vs 6) where
    # strips cost 10.  Takes precedence over ``blk`` when set.


@dataclasses.dataclass(frozen=True)
class AmgHierarchy:
    """Static SA hierarchy; ``levels[0]`` is the fine level, the coarsest is
    solved by a precomputed dense inverse (one dense matvec)."""

    levels: Tuple[AmgLevel, ...]
    coarse_inv: jnp.ndarray  # (nc, nc)
    smoother: str  # "jacobi" | "chebyshev"
    pre: int
    post: int
    omega: float  # jacobi damping

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1


jax.tree_util.register_dataclass(
    AmgLevel,
    data_fields=["A", "P", "R", "inv_diag", "agg", "w"],
    meta_fields=["cheb_bounds", "nc", "sa_c", "blk", "blk_nd"],
)
jax.tree_util.register_dataclass(
    AmgHierarchy,
    data_fields=["levels", "coarse_inv"],
    meta_fields=["smoother", "pre", "post", "omega"],
)


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------


def _strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength of connection: keep ``|a_ij| >= theta *
    sqrt(|a_ii a_jj|)`` plus the diagonal.  ``theta=0`` keeps every nonzero
    (the right default for isotropic problems); raise it (~0.08-0.25) to make
    aggregates follow the strong direction of anisotropic operators."""
    if theta <= 0.0:
        return A
    d = np.sqrt(np.abs(A.diagonal()))
    coo = A.tocoo()
    keep = np.abs(coo.data) >= theta * d[coo.row] * d[coo.col]
    keep |= coo.row == coo.col
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape
    )


def _infer_grid(
    n: int, offsets, max_extent: int = 3, min_pitch: int = 8, max_dims: int = 3
) -> Optional[Tuple[int, ...]]:
    """Recover a tensor-grid shape from a banded offset set, or ``None``.

    A matrix discretized on an (n_d, ..., n_1) grid in row-major order has
    offsets of the form ``sum_k d_k * pitch_k`` with ``pitch_1 = 1``,
    ``pitch_2 = n_1``, ``pitch_3 = n_1 n_2`` and small per-axis reaches
    ``|d_k| <= max_extent``.  The pitch of axis 2 is recovered as the first
    "jump" offset (up to ±max_extent slack for cross-diagonal legs, e.g. the
    9-point stencil's nx-1); every offset must decompose and the pitch must
    divide n.  ``min_pitch`` rejects narrow false positives (a flat band of
    width ~2p decomposes over any p; a genuine grid stencil has pitch >= its
    axis length).  Returns the grid row-major (outermost first).
    """
    pos = sorted(int(o) for o in offsets if int(o) > 0)
    if not pos or n <= 1:
        return None
    jumps = [o for o in pos if o > max_extent]
    if not jumps:
        return (n,)  # pure 1-D stencil
    # EVERY divisible candidate is scored and the minimum-total-|dx| pitch
    # wins: the true pitch makes cross-diagonal legs decompose with dx in
    # {-1, 0, 1}, while an off-by-d pitch shifts every jump offset by d.
    # First-accept ordering mis-inferred (9, 12) as (12, 9) and (10, 12)
    # as (12, 10) whenever the wrong pitch also divides n (review finding,
    # pinned by test).
    cands = sorted(
        {jumps[0] + d for d in range(-max_extent, max_extent + 1)}
        - set(range(min_pitch))
    )
    best = None  # (score, grid)
    for p in cands:
        if n % p:
            continue
        rest = set()
        ok = True
        score = 0
        for o in pos:
            dx = ((o + max_extent) % p) - max_extent
            if abs(dx) > max_extent:
                ok = False
                break
            score += abs(dx)
            r = (o - dx) // p
            if r:
                rest.add(r)
        if not ok:
            continue
        if not rest or max(rest) <= max_extent:
            grid = (n // p, p)  # 2-D: all row-jumps within reach
        elif max_dims > 2:
            sub = _infer_grid(
                n // p, sorted(rest), max_extent, min_pitch, max_dims - 1
            )
            if sub is None or len(sub) > max_dims - 1:
                continue
            grid = sub + (p,)
        else:
            continue
        if best is None or score < best[0]:
            best = (score, grid)
    return best[1] if best is not None else None


def _aggregate(S: sp.csr_matrix) -> Tuple[np.ndarray, int]:
    """Greedy aggregation over the strength graph (Vaněk's three passes).

    Pass 1 seeds an aggregate around every node whose strong neighborhood is
    untouched; pass 2 attaches leftovers to their most strongly connected
    aggregate; pass 3 groups whatever remains (isolated pockets) into fresh
    aggregates.  Returns (aggregate id per node, number of aggregates); every
    node is assigned.
    """
    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, np.abs(S.data)
    from conjugategradient_tpu import native

    fast = native.aggregate(indptr, indices, data)
    if fast is not None:
        return fast
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):  # pass 1
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if (agg[nbrs] == -1).all():
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    for i in range(n):  # pass 2
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs, vals = indices[sl], data[sl]
        m = (nbrs != i) & (agg[nbrs] != -1)
        if m.any():
            agg[i] = agg[nbrs[m][np.argmax(vals[m])]]
    for i in range(n):  # pass 3
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        grp = nbrs[agg[nbrs] == -1]
        agg[i] = n_agg
        agg[grp] = n_agg
        n_agg += 1
    return agg, n_agg


def _tentative(agg: np.ndarray, n_agg: int, z: np.ndarray) -> sp.csr_matrix:
    """Tentative prolongator: column j = the near-null candidate restricted
    to aggregate j, normalized (so P0^T P0 = I — the standard SA scaling)."""
    nrm = np.sqrt(np.bincount(agg, weights=z * z, minlength=n_agg))
    nrm[nrm == 0.0] = 1.0
    n = agg.shape[0]
    return sp.csr_matrix(
        (z / nrm[agg], (np.arange(n), agg)), shape=(n, n_agg)
    )


def _lam_max_scaled(A: sp.csr_matrix, iters: int = 30) -> float:
    """Host power iteration for lam_max(D^{-1}A) (+10% margin), the same
    convention as ``eigen.scaled_spectrum_bounds``."""
    inv_d = 1.0 / A.diagonal()
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = inv_d * (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return 1.1 * lam


def _to_device_csr(S: sp.csr_matrix, dtype) -> CsrMatrix:
    from conjugategradient_tpu.core.io import from_scipy

    return from_scipy(S.tocsr()).device_put(dtype=dtype)


def _to_device_level_op(
    S: sp.csr_matrix, dtype, layout: str, max_blowup: float, grid=None
):
    """Square level operator -> device container, DIA when the diagonal
    storage blowup allows (``load_matrix_market``'s auto rule).

    ``grid`` (set for ND-blocked levels): relayout onto the STENCIL fast
    path — grid-shaped coefficients, grid-shaped vectors level-wide.  A
    flat DIA level streams one shifted copy of x per diagonal, and every
    flat<->grid transfer boundary pays a relayout; the stencil path fuses
    into one loop, and Poisson-like levels const-detect to ZERO matrix
    bytes.  Falls back to DIA/CSR when the offsets don't decompose onto
    the grid.

    Gather-form CSR segment-sum SpMVs are the slow path for level
    operators.  Aggregation preserves bandedness (aggregates group
    neighbouring rows), so mesh-like matrices relayout every level onto
    its diagonal set and ride the DIA fast paths; genuinely irregular
    matrices (random permutations) keep CSR honestly.  Transfers stay CSR
    (2 applications per level per cycle vs the smoothers' 2*(pre+post)+1
    operator applications — not the dominant term).
    """
    if layout == "auto":
        from conjugategradient_tpu.core.formats import csr_to_dia

        csr_host = S.tocsr()
        coo = csr_host.tocoo()
        diags = np.unique(coo.col.astype(np.int64) - coo.row)
        n = csr_host.shape[0]
        if len(diags) * n <= max_blowup * max(csr_host.nnz, 1):
            from conjugategradient_tpu.core.io import from_scipy

            dia = csr_to_dia(
                from_scipy(csr_host), offsets=tuple(int(o) for o in diags)
            )
            if grid is not None:
                from conjugategradient_tpu.core.formats import (
                    dia_to_stencil,
                    stencil_to_const,
                )

                try:
                    st = dia_to_stencil(dia, tuple(grid))
                except ValueError:
                    st = None  # offsets don't decompose / seam wraps nonzero
                if st is not None:
                    return (stencil_to_const(st) or st).device_put(dtype=dtype)
            return dia.device_put(dtype=dtype)
    return _to_device_csr(S, dtype)


def build_amg_hierarchy(
    A,
    theta: float = 0.0,
    near_null: Optional[np.ndarray] = None,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 200,
    max_levels: int = 12,
    min_coarsen: float = 0.9,
    smooth_prolongator="auto",
    dtype=None,
    layout: str = "auto",
    max_blowup: float = 3.0,
    aggregation: str = "auto",
    blk: int = 4,
    infer_grid: bool = True,
) -> AmgHierarchy:
    """Set up a smoothed-aggregation hierarchy from ANY sparse container.

    ``A``: any ``core.formats`` matrix or ``scipy.sparse`` matrix — no grid
    required.  ``near_null``: the algebraically smooth candidate the coarse
    space must capture (default: the constant vector — right for Laplacians;
    pass the known near-kernel for scaled/rotated problems).  Coarsening
    stops at ``max_coarse`` unknowns, ``max_levels``, or when a level fails
    to shrink below ``min_coarsen * n`` (stagnation guard: a diagonal-ish
    matrix aggregates into singletons and multigrid adds nothing).

    ``aggregation`` precedence: ``"auto"`` picks greedy / 1-D strips / N-D
    cubes by structure — cube (edge-3, grid-inferred, stencil-relayouted)
    whenever ``_infer_grid`` finds a tensor grid AND the operator passes the
    row-seam validation; explicit ``"blocked"`` always means the 1-D strips
    with the caller's ``blk`` (no inference — the pre-r5 contract);
    ``infer_grid=False`` disables inference under ``"auto"`` too.

    ``smooth_prolongator``: Jacobi-smooth the tentative P (true SA — the SPD
    choice; cuts Poisson iteration counts ~2x vs plain aggregation).  For
    NONSYMMETRIC operators a piecewise-constant P keeps the Galerkin coarse
    operator an M-matrix whenever A is one (row sums and signs are preserved
    under aggregation), where the smoothed P's signed entries destroy upwind
    stability — measured on 255x255/511x511 upwind convection-diffusion
    (eps=0.05): smoothed-P BiCGStab DIVERGES, plain-P converges in 41/25
    iterations.  Default ``"auto"`` (r5): smooth iff the FINE operator is
    symmetric — previously the cure required a kwarg no caller plumbed.
    """
    from conjugategradient_tpu.core.io import to_scipy

    A_h = (A if sp.issparse(A) else to_scipy(A)).tocsr()
    dt = np.dtype(dtype) if dtype is not None else np.asarray(A_h.data).dtype
    z = np.ones(A_h.shape[0]) if near_null is None else np.asarray(near_null, np.float64)
    if z.shape != (A_h.shape[0],):
        raise ValueError(f"near_null must be ({A_h.shape[0]},), got {z.shape}")

    if aggregation not in ("auto", "greedy", "blocked"):
        raise ValueError(f"unknown aggregation {aggregation!r}")

    def _bandable(S):
        coo = S.tocoo()
        diags = np.unique(coo.col.astype(np.int64) - coo.row)
        return len(diags) * S.shape[0] <= max_blowup * max(S.nnz, 1)

    def _has_offdiag(S):
        coo = S.tocoo()
        off = coo.data[coo.row != coo.col]
        return off.size > 0 and np.abs(off).max() > 1e-12 * np.abs(S.data).max(initial=1.0)

    levels = []
    def _sym_of(S):
        d_asym = (S - S.T).tocoo()
        return bool(
            np.abs(d_asym.data).max(initial=0.0)
            <= 1e-12 * np.abs(S.data).max(initial=0.0)
        )

    sym_fine = _sym_of(A_h)  # computed once; reused by auto + first level
    if smooth_prolongator == "auto":
        smooth_prolongator = sym_fine
    smooth_prolongator = bool(smooth_prolongator)

    grid_nd = None  # inferred tensor grid, tracked down the ND-blocked levels
    nd_checked = False
    prebuilt_st = None  # level-0 stencil validated during grid inference
    while A_h.shape[0] > max_coarse and len(levels) < max_levels - 1:
        diag = A_h.diagonal()
        if np.any(diag <= 0):
            raise ValueError(
                "non-positive diagonal; not compatible with Jacobi scaling "
                "(for symmetric indefinite systems use minres with a "
                "different preconditioner)"
            )
        n_lvl = A_h.shape[0]
        # fine level reuses the up-front symmetry check (O(nnz log nnz))
        sym = sym_fine if not levels else _sym_of(A_h)
        # contiguous (blocked) aggregation whenever the level is a banded
        # SYMMETRIC operator with real off-diagonal structure: transfers
        # lower to reshape-sum/broadcast (no gathers), and Galerkin of a
        # banded A over contiguous blocks stays banded, so EVERY level keeps
        # the DIA fast path (no CSR tail).  Gates:
        # nonsymmetric operators keep greedy (strip aggregates ignore the
        # convection direction — measured 143 vs 12 BiCGStab its), as do
        # strength-degenerate (diagonal-dominated) matrices where greedy's
        # stagnation guard must still disable multigrid entirely.
        # blocked-eligible: symmetric smoothed-SA levels OR
        # any unsmoothed level (composition transfers are exact with
        # sa_c=0 regardless of symmetry — this is how NONSYMMETRIC inputs
        # reach the zero-gather cycle)
        want_blocked = aggregation == "blocked" or (
            aggregation == "auto"
            and ((sym and smooth_prolongator) or not smooth_prolongator)
            and _bandable(A_h)
            and _has_offdiag(A_h)
        )
        # N-D upgrade (r5): when the banded offsets reveal a tensor grid,
        # use CUBE blocks (edge 3) instead of 1-D strips — same zero-gather
        # reshape transfers, but the Galerkin stencil stays invariant down
        # the hierarchy and iteration counts match greedy (see AmgLevel.
        # blk_nd).  Inference runs once, on the finest blockable level;
        # coarse grids follow by division.
        blk_nd_lvl = None
        if (want_blocked and infer_grid and not nd_checked
                and aggregation != "blocked"):
            # explicit aggregation="blocked" is a request for the 1-D
            # strips with the caller's blk — only "auto" upgrades to cubes
            nd_checked = True
            coo0 = A_h.tocoo()
            diags0 = np.unique(coo0.col.astype(np.int64) - coo0.row)
            g_found = _infer_grid(n_lvl, diags0)
            if g_found is not None and len(g_found) >= 2:
                # validate the inference against the operator itself: a
                # genuine grid stencil has exact zeros at every row seam
                # (dia_to_stencil's O(boundary) check) — a divisible-but-
                # wrong pitch (e.g. a flat {1,2,5} band with 8 | n) fails
                # here and falls back to strips/greedy instead of silently
                # aggregating across physical grid rows
                from conjugategradient_tpu.core.formats import (
                    csr_to_dia,
                    dia_to_stencil,
                )
                from conjugategradient_tpu.core.io import from_scipy

                try:
                    dia0 = csr_to_dia(
                        from_scipy(A_h.tocsr()),
                        offsets=tuple(int(o) for o in diags0),
                    )
                    st0 = dia_to_stencil(dia0, tuple(g_found), copy=False)
                    grid_nd = g_found
                    # reuse the validated relayout for level 0 instead of
                    # re-materialising the (ndiags, n) band inside
                    # _to_device_level_op (~1 GB twice at 16M rows)
                    from conjugategradient_tpu.core.formats import (
                        stencil_to_const,
                    )

                    prebuilt_st = (stencil_to_const(st0) or st0).device_put(
                        dtype=dt
                    )
                except ValueError:
                    pass
        # 1-D strips stay gated to symmetric smoothed levels (measured: on
        # convection they ignore the flow direction, 143-vs-12 its) unless
        # explicitly requested; cube blocks are isotropic like greedy's
        # aggregates and carry nonsymmetric levels too (measured below).
        blocked = want_blocked and (
            grid_nd is not None
            or (sym and smooth_prolongator)
            or aggregation == "blocked"
        )
        if blocked and grid_nd is not None:
            blks = tuple(3 if g >= 3 else 1 for g in grid_nd)
            cgrid = tuple(-(-g // b) for g, b in zip(grid_nd, blks))
            coords = []
            rem = np.arange(n_lvl, dtype=np.int64)
            for g in reversed(grid_nd):
                coords.append(rem % g)
                rem //= g
            coords = coords[::-1]
            agg = np.zeros(n_lvl, dtype=np.int64)
            for c, b_ax, cg in zip(coords, blks, cgrid):
                agg = agg * cg + c // b_ax
            n_agg = int(np.prod(cgrid))
            blk_nd_lvl = (tuple(grid_nd), blks)
        elif blocked:
            agg = np.arange(n_lvl, dtype=np.int64) // int(blk)
            n_agg = int(-(-n_lvl // int(blk)))
        else:
            agg, n_agg = _aggregate(_strength_graph(A_h, theta))
        if n_agg >= min_coarsen * A_h.shape[0]:
            break  # aggregation stagnated; stop coarsening here
        lam_max = _lam_max_scaled(A_h)
        P0 = _tentative(agg, n_agg, z)
        if smooth_prolongator:
            Dinv = sp.diags(1.0 / diag)
            P = (P0 - (_SA_W / lam_max) * (Dinv @ (A_h @ P0))).tocsr()
        else:
            P = P0.tocsr()
        # composition-form transfers (exactness gate: see AmgLevel)
        sym = not smooth_prolongator or sym
        w_tent = np.asarray(P0[np.arange(A_h.shape[0]), agg]).ravel()
        if (prebuilt_st is not None and sym and blk_nd_lvl is not None
                and layout == "auto"):
            A_dev_lvl = prebuilt_st  # level 0, validated during inference
        else:
            A_dev_lvl = _to_device_level_op(
                A_h, dt, layout, max_blowup,
                grid=blk_nd_lvl[0] if (blk_nd_lvl is not None and sym) else None,
            )
        prebuilt_st = None
        from conjugategradient_tpu.core.formats import (
            ConstStencilMatrix as _CSt,
            StencilMatrix as _St,
        )

        # stencil-relayouted levels run the cycle GRID-SHAPED: store the
        # elementwise carriers grid-shaped too (one host reshape here
        # replaces a per-transfer device relayout)
        lvl_shape = A_dev_lvl.grid if isinstance(A_dev_lvl, (_St, _CSt)) else (-1,)
        levels.append(
            AmgLevel(
                A=A_dev_lvl,
                P=_to_device_csr(P, dt),
                R=_to_device_csr(P.T, dt),
                inv_diag=jnp.asarray((1.0 / diag).astype(dt).reshape(lvl_shape)),
                cheb_bounds=(0.25 * lam_max, lam_max),
                agg=jnp.asarray(agg, jnp.int32) if sym else None,
                w=jnp.asarray(w_tent.astype(dt).reshape(lvl_shape)) if sym else None,
                nc=int(n_agg),
                sa_c=float(_SA_W / lam_max) if smooth_prolongator else 0.0,
                blk=int(blk) if (blocked and sym and blk_nd_lvl is None) else 0,
                blk_nd=blk_nd_lvl if sym else None,
            )
        )
        # track (or drop) the inferred grid for the next level: a level
        # that did NOT aggregate in cubes breaks the grid lineage — a later
        # re-qualifying level must not reuse a stale shape whose product no
        # longer matches its n (review finding)
        grid_nd = cgrid if blk_nd_lvl is not None else None
        # Galerkin coarse operator and the candidate's coarse image
        # (P0^T z = the per-aggregate norms — the exact vector the next
        # level's tentative prolongator must reproduce).  Measured (r5):
        # scipy's csr_matmat beats a hand-banded diagonal product at every
        # level (0.06-0.19 s vs 0.4-1.1 s at 511^2) — the blocked-setup
        # cost is level COUNT and container conversions, not the products.
        A_h = (P.T @ (A_h @ P)).tocsr()
        z = np.asarray(P0.T @ z)

    coarse_inv = jnp.asarray(
        np.linalg.inv(A_h.toarray().astype(np.float64)).astype(dt)
    )
    return AmgHierarchy(
        levels=tuple(levels),
        coarse_inv=coarse_inv,
        smoother=smoother,
        pre=pre,
        post=post,
        omega=omega,
    )


# ---------------------------------------------------------------------------
# device-side cycle
# ---------------------------------------------------------------------------


def _smooth(h: AmgHierarchy, lvl: AmgLevel, op, b, x, sweeps: int, invd=None):
    invd = lvl.inv_diag if invd is None else invd
    if sweeps <= 0:
        return x
    if h.smoother == "chebyshev":
        lo, hi = lvl.cheb_bounds
        return chebyshev_smooth(op, invd, b, x, sweeps, hi, lo)
    return jacobi_smooth(op, invd, b, x, sweeps, h.omega)


def amg_vcycle(
    h: AmgHierarchy, b: jnp.ndarray, level: int = 0, gamma: int = 1
) -> jnp.ndarray:
    """One V- (``gamma=1``) or W- (``gamma=2``) cycle for ``A_level e = b``
    with zero initial guess.  Inter-level vectors are flat ``(n,)``; inside
    a stencil-relayouted ND level (see ``_to_device_level_op``) the whole
    level runs GRID-SHAPED — one reshape at level entry/exit instead of a
    layout conversion per transfer, and the operator applications ride the
    stencil roofline path.  Static recursion — fully unrolled at trace
    time, like ``multigrid.v_cycle``."""
    if level == len(h.levels):
        return jnp.dot(h.coarse_inv, b, precision=MATMUL_PRECISION,
                       preferred_element_type=b.dtype)
    lvl = h.levels[level]
    from conjugategradient_tpu.core.formats import (
        ConstStencilMatrix as _CSt,
        StencilMatrix as _St,
    )

    is_st = isinstance(lvl.A, (_St, _CSt))
    grid_mode = is_st and lvl.blk_nd is not None
    if is_st:
        op_g = partial(spmv, lvl.A)
        if grid_mode:
            op = op_g
        else:
            # stencil operator driven with flat vectors (e.g. a hierarchy
            # whose blk_nd was stripped to force the generic path)
            op = lambda v: op_g(v.reshape(lvl.A.grid)).reshape(-1)
    else:
        op = partial(spmv, lvl.A)
    # elementwise carriers in this level's cycle-vector shape (stored
    # grid-shaped for stencil levels; reshape is a no-op when it matches)
    tgt = lvl.A.grid if grid_mode else (-1,)
    invd = lvl.inv_diag.reshape(tgt)
    w = None if lvl.w is None else lvl.w.reshape(tgt)
    if lvl.blk_nd is not None:
        # N-D cube blocks: restrict = pad + interleaved reshape-sum over the
        # block axes, prolong = per-axis repeat + crop — zero gathers (see
        # AmgLevel.blk_nd).  Composition smoothing as in the 1-D form.
        grid_l, blks = lvl.blk_nd
        cgrid = tuple(-(-g // b_) for g, b_ in zip(grid_l, blks))
        pads = [(0, c * b_ - g) for c, b_, g in zip(cgrid, blks, grid_l)]
        inter = tuple(x for c, b_ in zip(cgrid, blks) for x in (c, b_))
        blk_axes = tuple(range(1, 2 * len(cgrid), 2))
        crop = tuple(slice(0, g) for g in grid_l)

        def restrict(v):  # grid-shaped in (grid_mode) -> flat coarse out
            if lvl.sa_c:
                v = v - lvl.sa_c * op(invd * v)
            t = w * v
            t = jnp.pad(t if grid_mode else t.reshape(grid_l), pads)
            return t.reshape(inter).sum(axis=blk_axes).reshape(-1)

        def prolong(e):  # flat coarse in -> grid-shaped out (grid_mode)
            # per-axis jnp.repeat rather than an interleaved
            # broadcast_to+reshape, which lowers to a slower relayout
            t = e.reshape(cgrid)
            for ax, b_ in enumerate(blks):
                if b_ > 1:
                    t = jnp.repeat(t, b_, axis=ax)
            t = t[crop]
            t = (t if grid_mode else t.reshape(-1)) * w
            if lvl.sa_c:
                t = t - lvl.sa_c * (invd * op(t))
            return t

    elif lvl.blk:
        # contiguous blocks: restrict = reshape-sum, prolong = broadcast-
        # reshape — no gathers/scatters anywhere (see AmgLevel.blk).  Same
        # composition form otherwise.
        n_lvl = lvl.A.n
        pad = lvl.nc * lvl.blk - n_lvl

        def restrict(v):
            if lvl.sa_c:
                v = v - lvl.sa_c * op(invd * v)
            t = jnp.pad(w * v, (0, pad))
            return t.reshape(lvl.nc, lvl.blk).sum(axis=1)

        def prolong(e):
            t = jnp.broadcast_to(e[:, None], (lvl.nc, lvl.blk)).reshape(-1)
            t = t[:n_lvl] * w
            if lvl.sa_c:
                t = t - lvl.sa_c * (invd * op(t))
            return t

    elif lvl.agg is not None:
        # composition form: ONE entry per row.  R v = P0^T (v - c A D^{-1} v)
        # and P e = t - c D^{-1} A t with t = w * e[agg] — reuses the
        # (relayouted) level operator instead of gather-heavy CSR transfers
        def restrict(v):
            if lvl.sa_c:
                v = v - lvl.sa_c * op(invd * v)
            return jax.ops.segment_sum(w * v, lvl.agg, num_segments=lvl.nc)

        def prolong(e):
            t = w * e[lvl.agg]
            if lvl.sa_c:
                t = t - lvl.sa_c * (invd * op(t))
            return t

    else:
        restrict = partial(spmv_csr, lvl.R)
        prolong = partial(spmv_csr, lvl.P)
    bl = b.reshape(lvl.A.grid) if grid_mode else b
    x = _smooth(h, lvl, op, bl, jnp.zeros_like(bl), h.pre, invd)
    reps = gamma if level > 0 else 1
    for _ in range(reps):
        rc = restrict(bl - op(x))
        ec = amg_vcycle(h, rc, level + 1, gamma)
        x = x + prolong(ec)
    x = _smooth(h, lvl, op, bl, x, h.post, invd)
    return x.reshape(-1) if grid_mode else x


def amg_preconditioner(
    h: AmgHierarchy, gamma: int = 1
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """M(r) = one SA cycle.  SPD by construction (R = P^T, symmetric
    smoothing), so valid for ``cg_solve(..., M=...)`` — and usable as the
    right preconditioner of ``bicgstab_solve``/``gmres_solve`` for mildly
    nonsymmetric systems.  Handles flat ``(n,)`` vectors and ``(n, k)``
    blocks (vmapped over columns, for ``cg_solve_multi``/``lobpcg``)."""

    def M(r):
        if r.ndim == 2:
            return jax.vmap(
                lambda c: amg_vcycle(h, c, gamma=gamma), in_axes=1, out_axes=1
            )(r)
        return amg_vcycle(h, r, gamma=gamma)

    return M


def amg_cg_solve(
    A,
    b,
    x0=None,
    policy=None,
    hierarchy: Optional[AmgHierarchy] = None,
    gamma: int = 1,
    dtype=None,
    **setup_kw,
):
    """Smoothed-aggregation-preconditioned CG — MGCG for matrices with no
    grid.  Returns ``(CGResult, AmgHierarchy)`` so the hierarchy (the
    expensive part) can be reused across solves with the same sparsity."""
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    h = hierarchy or build_amg_hierarchy(
        A, dtype=dtype or np.asarray(b).dtype, **setup_kw
    )
    A_dev = A.device_put(dtype=dtype) if hasattr(A, "device_put") else A
    b_dev = jnp.asarray(np.asarray(b), dtype=dtype)
    x0_dev = None if x0 is None else jnp.asarray(np.asarray(x0), dtype=dtype)
    res = cg_solve(A_dev, b_dev, x0_dev, policy, M=amg_preconditioner(h, gamma))
    return res, h
