"""Geometric multigrid: hierarchy setup, V-cycle, and the MGCG preconditioner.

This is the capability the reference's name promises but never implements
(SURVEY.md §0 "naming caveat": "Mgcg" = multigrid-preconditioned CG per
``Mgcg/cuBlas/Mgcg/MgcgMain.cs:8``, yet every solver in the repo is plain CG).
Designed for a device-resident solve:

- **Setup is host-side and static.**  Coarse operators are the Galerkin
  products ``A_c = R A P`` computed once with scipy.sparse and converted back
  to DIA — so every level's offsets/shapes are compile-time metadata, exactly
  like the fine level.
- **The cycle is one traced program.**  Levels form a static python list; the
  V-cycle recursion unrolls at trace time into a fixed DAG of SpMVs,
  restrictions, prolongations and smoother sweeps — no data-dependent control
  flow, everything fused by XLA, one dense matvec for the coarsest solve.
- **Symmetric by construction.**  R = P^T / 2^d, identical pre/post smoothing
  — the V-cycle is then a symmetric positive definite operator, a valid PCG
  preconditioner (plug ``as_preconditioner`` into ``cg_solve(..., M=...)``).

Smoothers: weighted Jacobi or Chebyshev (``precond.smoothers``), with spectral
bounds estimated at setup by ``solvers.eigen``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from conjugategradient_tpu.core import formats
from conjugategradient_tpu.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
    dia_diagonal,
    dia_to_stencil,
    stencil_to_const,
)
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
from conjugategradient_tpu.precond import transfer
from conjugategradient_tpu.precond.smoothers import (
    chebyshev_smooth,
    jacobi_smooth,
    parity_mask,
    redblack_gs_smooth,
    redblack_gs_smooth_reversed,
)
from conjugategradient_tpu.solvers import eigen

GridShape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MgLevel:
    """One level: operator + smoother data + its grid geometry (static)."""

    A: DiaMatrix  # device DIA/Stencil operator at this level
    inv_diag: jnp.ndarray  # (n,) or grid-shaped 1/diag(A)
    grid: GridShape  # this level's grid shape (prod == A.n)
    cheb_bounds: Tuple[float, float]  # spectral bounds of D^{-1}A (static floats)
    mask: Optional[jnp.ndarray] = None  # checkerboard parity (rbgs smoother)
    transfer: str = "fw"  # "fw" (full weighting, odd axes) | "agg" (any size)
    weight: Optional[jnp.ndarray] = None  # SA tentative-prolongator weights (agg)
    sa_smooth: bool = True  # agg only: P smoothed by (I - c D^{-1}A)?  Plain
    # (weighted, unsmoothed) aggregation keeps coarse stencils at extent 1 —
    # mandatory for the distributed probing setup's bounded leg count


@dataclasses.dataclass(frozen=True)
class MgHierarchy:
    """Static multigrid hierarchy.  ``levels[0]`` is the fine grid; the
    coarsest level is solved directly with a precomputed dense inverse
    (one dense matvec at ``MATMUL_PRECISION``)."""

    levels: Tuple[MgLevel, ...]
    coarse_inv: jnp.ndarray  # (nc, nc) dense inverse of the coarsest A
    smoother: str  # "jacobi" | "chebyshev"
    pre: int  # pre-smooth sweeps / chebyshev degree
    post: int  # post-smooth sweeps / chebyshev degree
    omega: float  # jacobi damping

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1  # + coarsest direct level


# Registered pytrees: hierarchies pass through jit *as arguments* rather than
# being baked in as closure constants — mandatory at scale (a 16M-row
# hierarchy embedded as constants produced a ~600 MB XLA payload).
jax.tree_util.register_dataclass(
    MgLevel,
    data_fields=["A", "inv_diag", "mask", "weight"],
    meta_fields=["grid", "cheb_bounds", "transfer", "sa_smooth"],
)
jax.tree_util.register_dataclass(
    MgHierarchy,
    data_fields=["levels", "coarse_inv"],
    meta_fields=["smoother", "pre", "post", "omega"],
)


def _dia_to_scipy(A: DiaMatrix) -> sp.csr_matrix:
    """Direct DIA -> scipy.dia -> csr (C-speed; the numpy COO roundtrip was
    ~10x the cost of the Galerkin product itself on 10M-row setups).

    Layout shim: our data is row-indexed (``data[k, i] = A[i, i+off]``),
    scipy's is column-indexed (``data[k, j] = A[j-off, j]``) — shift by off.
    """
    n = A.n
    data = np.asarray(A.data)
    sdata = np.zeros_like(data)
    for k, off in enumerate(A.offsets):
        if off >= 0:
            sdata[k, off:] = data[k, : n - off]
        elif off < 0:
            sdata[k, : n + off] = data[k, -off:]
    return sp.dia_matrix((sdata, np.asarray(A.offsets)), shape=(n, n)).tocsr()


def _scipy_to_dia(S: sp.spmatrix) -> DiaMatrix:
    """scipy -> DIA via scipy's own .todia() (C-speed), un-shimming the
    column-indexed layout back to row-indexed."""
    D = S.todia()
    n = D.shape[0]
    offsets = tuple(int(o) for o in D.offsets)
    order = np.argsort(offsets)
    sdata = np.asarray(D.data)
    out = np.zeros((len(offsets), n), dtype=sdata.dtype)
    for slot, k in enumerate(order):
        off = offsets[k]
        if off >= 0:
            out[slot, : n - off] = sdata[k, off:]
        else:
            out[slot, -off:] = sdata[k, : n + off]
    return DiaMatrix(out, tuple(offsets[k] for k in order), (n, n))


#: smoothed-aggregation damping: omega = 4 / (3 * lam_max(D^{-1}A))
_SA_W = 4.0 / 3.0


def _near_null(A_h: DiaMatrix, grid: GridShape) -> np.ndarray:
    """Near-null candidate for the aggregation coarse space.

    The vector the coarse space must represent is whatever the smoother
    cannot damp.  For Laplacian-like matrices (negative off-diagonals) that
    is the **constant**; for consistently *positive* off-diagonals (the
    reference's tridiagonal (+1, 2, +1)) it is the **checkerboard-alternating
    vector** — the diag(±1) conjugation of the constant, a structure
    geometric intuition misses (constant-based aggregation leaves 100% of its
    energy uncorrected there; measured rho = 0.996 vs 0.07 with the right
    candidate).  Critically, the candidate must be *globally* smooth: a
    relaxed-random vector is only locally smooth and its wiggles destroy the
    approximation property mesh-dependently (measured rho -> 1 as n grows).
    So we pick, deterministically, whichever of the two global candidates has
    the smaller Rayleigh quotient z^T A z / z^T z.
    """
    from conjugategradient_tpu.core import oracle as _oracle

    ones = np.ones(A_h.n)
    alt = np.where(np.indices(grid).sum(axis=0).reshape(-1) % 2 == 0, 1.0, -1.0)
    best, best_q = None, np.inf
    for z in (ones, alt):
        q = float(z @ _oracle.spmv(A_h, z)) / float(z @ z)
        if q < best_q:
            best, best_q = z, q
    return best


def _axis_strengths(A_h: DiaMatrix, grid: GridShape, st=None) -> np.ndarray:
    """Per-axis coupling strength: max |value| over the AXIS-ALIGNED
    off-diagonal stencil legs (the classic semicoarsening detector —
    anisotropic operators couple strongly along some axes only, and the
    point smoother leaves error smooth only along those).  Pass ``st``
    when the stencil form already exists (build_hierarchy) to skip a
    second full-size conversion."""
    if st is None:
        st = dia_to_stencil(A_h, grid)
    d = len(grid)
    out = np.zeros(d)
    data = np.asarray(st.data)
    for k, shift in enumerate(st.shifts):
        nz = [ax for ax in range(d) if shift[ax] != 0]
        if len(nz) == 1:
            out[nz[0]] = max(out[nz[0]], float(np.max(np.abs(data[k]))))
    return out


def _const_near_null(A_h: DiaMatrix, grid: GridShape) -> bool:
    """True iff the constant (not the checkerboard) is the near-null
    candidate — the precondition for GEOMETRIC transfers (fw/cc linear
    interpolation assume smooth = constant-like error; on alternating
    near-null operators like the (+1, 2, +1) tridiagonal they leave the
    slow mode uncorrected — measured 1541 MGCG its vs 4 with aggregation
    at n=4096)."""
    from conjugategradient_tpu.core import oracle as _oracle

    ones = np.ones(A_h.n)
    alt = np.where(np.indices(grid).sum(axis=0).reshape(-1) % 2 == 0, 1.0, -1.0)
    q1 = float(ones @ _oracle.spmv(A_h, ones))
    q2 = float(alt @ _oracle.spmv(A_h, alt))
    return q1 <= q2


def _agg_weights(z: np.ndarray, grid: GridShape):
    """Per-aggregate-normalised candidate -> (W, z_coarse).

    Aggregates are tensor products of per-axis index pairs (odd tails are
    singletons).  ``P_t = diag(W) @ P_plain`` has orthonormal columns and
    reproduces ``z`` exactly (``P_t z_c = z``).
    """
    zz = (z * z).reshape(grid)
    for ax in range(len(grid)):
        m = zz.shape[ax]
        zm = np.moveaxis(zz, ax, -1)
        if m % 2:
            zm = np.concatenate([zm, np.zeros(zm.shape[:-1] + (1,))], axis=-1)
        zm = zm.reshape(zm.shape[:-1] + (-1, 2)).sum(axis=-1)
        zz = np.moveaxis(zm, -1, ax)
    nrm = np.sqrt(zz)  # coarse-grid aggregate norms
    # expand nrm back to the fine grid (plain prolongation = repeat/truncate)
    expand = nrm
    for ax in range(len(grid)):
        expand = np.moveaxis(
            np.repeat(np.moveaxis(expand, ax, -1), 2, axis=-1)[..., : grid[ax]], -1, ax
        )
    expand = expand.reshape(-1)
    ok = expand > 0
    W = np.where(ok, z / np.where(ok, expand, 1.0), 1.0)
    return W, nrm.reshape(-1)


def _const_bounds(Ac: ConstStencilMatrix, lower_frac: float = 0.25):
    """Chebyshev smoothing interval for a CONST-coefficient stencil, with no
    host power iteration: Gershgorin on D^{-1}A bounds lam_max by
    ``1 + sum|c_off| / c_center`` — for the Dirichlet Laplacians this is
    exactly the spectral sup (2.0), tighter than the power-iteration
    estimate with its 1.1 safety margin (measured 2.14 at 255^3), and it
    replaces a ~20 s host probe on 16.6M rows with arithmetic."""
    c0 = None
    rad = 0.0
    for c, s in zip(Ac.coeffs, Ac.shifts):
        if all(d == 0 for d in s):
            c0 = float(c)
        else:
            rad += abs(float(c))
    if c0 is None or c0 <= 0:
        raise ValueError("const stencil lacks a positive center coefficient")
    lam_max = 1.0 + rad / c0
    return lower_frac * lam_max, lam_max


def galerkin_coarse(
    A: DiaMatrix,
    fine: GridShape,
    kind: str = "fw",
    lam_max: float | None = None,
    weight: np.ndarray | None = None,
    sa_smooth: bool = True,
) -> DiaMatrix:
    """A_c = R A P on the host (setup-time scipy triple product).

    ``kind``: "fw" = full-weighting/linear (odd axes); "agg" = *smoothed
    aggregation* (any size): tentative prolongator built from the computed
    near-null candidate (``weight`` = per-aggregate-normalised candidate, see
    ``_near_null``/``_agg_weights``), smoothed once by ``(I - omega D^{-1} A)``
    with omega = 4/(3 lam_max).  R = P^T / 2^d in both (the scaling cancels
    through the coarse solve).
    """
    S = _dia_to_scipy(A)
    if kind == "fw":
        P = transfer.prolong_matrix(fine)
    elif kind == "hyb":
        P = transfer.prolong_hybrid_matrix(fine)
    elif kind.startswith("semi"):
        # SEMI-coarsening: identity on weakly-coupled axes; R scales by
        # 1/2 per COARSENED axis only
        mask = _semi_mask(kind)
        P = transfer.prolong_partial_matrix(fine, mask)
        R = (P.T * (0.5 ** sum(mask))).tocsr()
        return _scipy_to_dia((R @ S @ P).tocsr())
    else:
        P = transfer.prolong_agg_matrix(fine)
        if weight is None:
            weight, _ = _agg_weights(_near_null(A, fine), fine)
        P = sp.diags(np.asarray(weight).reshape(-1)) @ P
        if sa_smooth:
            if lam_max is None:
                lam_max = eigen.scaled_spectrum_bounds(A)[1]
            Dinv = sp.diags(1.0 / dia_diagonal(A))
            P = (P - (_SA_W / lam_max) * (Dinv @ (S @ P))).tocsr()
    R = (P.T * (0.5 ** len(fine))).tocsr()
    Ac = R @ S @ P
    return _scipy_to_dia(Ac)


def build_hierarchy(
    A: DiaMatrix,
    grid: GridShape,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    dtype=None,
    layout: str = "stencil",
    sa_smooth_levels: int | None = None,
    const_detect: bool = True,
    transfer_kind: str = "auto",
    coarse_operator=None,
    semicoarsen: bool = True,
    semi_theta: float = 0.25,
) -> MgHierarchy:
    """Build the static hierarchy from the fine operator.

    ``grid`` is the tensor-grid shape of the unknowns (prod(grid) == A.n);
    1-D problems (tridiagonal, the banded |sin| family) use ``(n,)``.  Axes
    must be odd to coarsen; coarsening stops at ``max_coarse`` unknowns or
    when an axis becomes even.

    ``layout="stencil"`` (default) stores each level as a grid
    ``StencilMatrix`` and the V-cycle runs on grid-shaped arrays — the
    fast path (see ``ops.stencil``).  ``layout="dia"`` keeps flat DIA
    levels and flat vectors.

    ``sa_smooth_levels``: smooth the aggregation prolongator on only the
    first k agg levels (None = all, the strongest cycle).  SA smoothing
    widens coarse stencils by one ring per level (measured: extent 1 -> 2 ->
    3 ...); plain weighted aggregation contracts them back to extent 1, so
    ``sa_smooth_levels=1`` keeps every operator a bounded stencil — what the
    distributed (probing) setup and very deep hierarchies need, at a small
    iteration-count cost.

    ``coarse_operator``: REDISCRETIZATION hook — ``fn(level, coarse_grid) ->
    host DiaMatrix`` (``level`` = index of the coarse level being built;
    the fine operator is level 0) replaces the Galerkin product.  This is
    the classic geometric-MG cure for operators whose Galerkin coarsening
    is unstable: for convection-dominated transport (cell Peclet >~ 1),
    Galerkin-of-upwind loses the M-matrix property after 1-2 coarsenings
    and the coarse-grid correction AMPLIFIES — measured here: mg_bicgstab
    on the eps=0.05 recirculating workload diverges from 127x127 up with
    EVERY smoother/depth combination, while upwind rediscretization (which
    keeps first-order stability at any Peclet) converges grid-independently
    (see ``generators.convection_diffusion_coarse_operator``; Trottenberg
    et al., *Multigrid*, §7.1-7.3 for the phenomenon).  Requires the
    GEOMETRIC transfer conventions (vertex-centered fw on odd axes and/or
    cell-centered hyb on even axes — measured to share one calibration;
    ``transfer_kind="agg"`` is refused, and if auto coarsening would fall
    back to aggregation the build STOPS and raises rather than mixing a
    mis-scaled rediscretized operator or silently densifying a large
    remainder).  The hook must bake in the per-level scaling matching that
    convention: this builder's measured factors are diffusion 1/4 and
    convection 1/2 per level, i.e. coarse = 0.5 * A_gen(eps/2, v) for the
    unit-spacing convection-diffusion family (calibrated by stencil
    moments in 1/2/3-D).
    """
    if layout not in ("stencil", "dia"):
        raise ValueError(f"unknown layout {layout!r}")
    if transfer_kind not in ("auto", "fw", "hyb", "agg"):
        raise ValueError(f"unknown transfer_kind {transfer_kind!r}")
    if int(np.prod(grid)) != A.n:
        raise ValueError(f"prod(grid)={int(np.prod(grid))} != n={A.n}")
    if smoother not in ("jacobi", "chebyshev", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_operator is not None and transfer_kind == "agg":
        # the fw/hyb geometric transfers share one calibrated scaling
        # (diffusion 1/4, convection 1/2 per level — measured identical for
        # vertex-centered odd axes and cell-centered even axes); weighted
        # aggregation adapts its transfers to the operator's near-null
        # space, so no fixed rediscretization scale exists for it
        raise ValueError(
            "coarse_operator (rediscretization) assumes the geometric "
            "fw/hyb transfer conventions; transfer_kind='agg' has no fixed "
            "calibration"
        )

    levels = []
    A_h = A  # host-side numpy DIA
    g = tuple(grid)
    def _pick_kind(gg, geom_ok=True):
        """auto: vertex-centered full weighting (all axes odd) > hybrid
        fw/cell-centered (mixed parity; ~2x fewer MGCG its than plain
        aggregation, extent-1 coarse stencils preserved) > aggregation.

        ``geom_ok`` gates the geometric (interpolating) transfers on the
        operator's near-null space being constant-like — see
        ``_const_near_null``.  Aggregation adapts its weights to either
        candidate, so it is always safe."""
        if transfer_kind != "auto":
            can = {
                "fw": transfer.can_coarsen,
                "hyb": transfer.can_hybrid,
                "agg": transfer.can_aggregate,
            }[transfer_kind]
            return transfer_kind if can(gg) else None
        if geom_ok and transfer.can_coarsen(gg):
            return "fw"
        # hyb only while the RESULTING coarse grid keeps every axis >= 5:
        # cell-centered Galerkin operators have extent 2, and on smaller
        # axes distinct grid shifts alias the same flat offset (no DIA
        # representation); the tiny tail is agg
        if geom_ok and transfer.can_hybrid(gg) and all(
            n >= 5 for n in transfer.hybrid_coarse_shape(gg)
        ):
            return "hyb"
        if transfer.can_aggregate(gg):
            return "agg"
        return None

    while (
        A_h.n > max_coarse
        and _pick_kind(g) is not None
        and len(levels) < max_levels - 1
    ):
        # host stencil conversion FIRST: const-detected levels (the whole
        # Poisson ladder) replace every full-size host probe below with
        # O(#legs) arithmetic on the coefficients — the near-null choice
        # (two 133M-row SpMVs at 511^3), the semicoarsening strengths (a
        # second full dia_to_stencil pass) and the Chebyshev power
        # iteration (~20 s at 255^3) all collapse
        A_st = A_const = None
        if layout == "stencil":
            # copy=False: A_st aliases A_h's buffer — both are transient
            # setup state here (A_h is replaced by the next coarse level,
            # nothing mutates either) and the copy is the dominant setup
            # cost at 511^3 (a 3.7 GB memcpy)
            A_st = dia_to_stencil(A_h, g, copy=False)
            A_const = stencil_to_const(A_st) if const_detect else None
        if A_const is not None:
            # EXACT closed form of _const_near_null's two Rayleigh
            # quotients for a const stencil: each leg (c, s) contributes to
            # ones.A.ones once per valid position — prod_ax(g_ax - |s_ax|)
            # of them — and the checkerboard conjugation multiplies that by
            # (-1)^{sum s_ax}.  (An interior-symbol shortcut that dropped
            # the boundary counts flipped the decision on 7/2000 random
            # coercive mixed-sign stencils — review finding; this form is
            # differentially exact.)
            def _q(signed: bool) -> float:
                tot = 0.0
                for c, sh in zip(A_const.coeffs, A_const.shifts):
                    cnt = 1.0
                    for ax, d in enumerate(sh):
                        cnt *= max(0, g[ax] - abs(d))
                    sgn = (-1.0) ** sum(sh) if signed else 1.0
                    tot += float(c) * sgn * cnt
                return tot

            geom_ok = _q(False) <= _q(True)
        else:
            geom_ok = _const_near_null(A_h, g)
        kind = _pick_kind(g, geom_ok=geom_ok)
        if kind is None:
            break
        if (
            semicoarsen
            and coarse_operator is None
            and transfer_kind == "auto"
            and kind in ("fw", "hyb")
            and len(g) > 1
        ):
            # SEMI-coarsening: under strong anisotropy the point smoother
            # leaves error smooth only along strongly-coupled axes, and
            # full coarsening degrades (measured 6 -> 130 MGCG its at
            # 127^2 as the cross-axis coefficient drops 1 -> 1e-3);
            # coarsen only axes within semi_theta of the strongest
            # coupling.  Isotropic operators select every axis and take
            # the ordinary fw/hyb path unchanged.
            if A_const is not None:
                s_ax = np.zeros(len(g))
                for c, s in zip(A_const.coeffs, A_const.shifts):
                    nz = [ax for ax in range(len(g)) if s[ax] != 0]
                    if len(nz) == 1:
                        s_ax[nz[0]] = max(s_ax[nz[0]], abs(float(c)))
            else:
                s_ax = _axis_strengths(A_h, g, st=A_st)
            if s_ax.max() > 0:
                mask = tuple(bool(v >= semi_theta * s_ax.max()) for v in s_ax)
                if not all(mask) and transfer.can_partial(g, mask):
                    kind = "semi" + "".join("1" if m else "0" for m in mask)
        if coarse_operator is not None and kind == "agg":
            # no calibrated rediscretization scale for weighted aggregation
            # (see the transfer_kind check above): stop here — the dense
            # coarse inverse takes over at whatever size remains
            break
        center = (0,) * len(g)
        if A_const is not None and center in A_const.shifts:
            # const level: the (scalar) diagonal, skipping the O(n) scan
            diag = np.asarray(
                [A_const.coeffs[A_const.shifts.index(center)]],
                np.asarray(A_h.data).dtype,
            )
        else:
            diag = dia_diagonal(A_h)
        if np.any(diag <= 0):
            raise ValueError("non-positive diagonal; not SPD-compatible with Jacobi scaling")
        if smoother == "chebyshev" or kind == "agg":
            if A_const is not None and kind != "agg":
                bounds = _const_bounds(A_const)
            else:
                bounds = eigen.scaled_spectrum_bounds(A_h)
        else:
            bounds = (0.0, 0.0)
        dt = dtype or np.asarray(A_h.data).dtype
        W_host = None
        sa_smooth = sa_smooth_levels is None or len(levels) < sa_smooth_levels
        if kind == "agg":
            W_host, _ = _agg_weights(_near_null(A_h, g), g)
        if layout == "stencil":
            if A_const is not None:
                # constant-coefficient level (the Poisson fine grids): zero
                # matrix bytes per SpMV, scalar inv_diag (broadcasts through
                # every smoother) — measured ~3x on the fine smoothing cost
                A_dev = A_const.device_put(dt)
                inv_d = jnp.asarray(np.asarray(1.0 / diag[0], dtype=dt))
            else:
                A_dev = A_st.device_put(dt)
                inv_d = jnp.asarray((1.0 / diag).astype(dt).reshape(g))
            mask = parity_mask(g) if smoother == "rbgs" else None
            W_dev = None if W_host is None else jnp.asarray(W_host.astype(dt).reshape(g))
        else:
            A_dev = A_h.device_put(dt)
            inv_d = jnp.asarray((1.0 / diag).astype(dt))
            mask = parity_mask((A_h.n,)) if smoother == "rbgs" else None
            W_dev = None if W_host is None else jnp.asarray(W_host.astype(dt))
        levels.append(
            MgLevel(
                A=A_dev,
                inv_diag=inv_d,
                grid=g,
                cheb_bounds=bounds,
                mask=mask,
                transfer=kind,
                weight=W_dev,
                sa_smooth=sa_smooth,
            )
        )
        g_next = _coarse_shape_of(g, kind)
        if coarse_operator is not None:
            A_h = coarse_operator(len(levels), g_next)
            if int(np.prod(g_next)) != A_h.n:
                raise ValueError(
                    f"coarse_operator returned n={A_h.n} for grid {g_next}"
                )
        else:
            A_h = galerkin_coarse(
                A_h, g, kind, lam_max=bounds[1] or None, weight=W_host,
                sa_smooth=sa_smooth,
            )
        g = g_next

    if coarse_operator is not None and A_h.n > 4 * max_coarse:
        # the docstring's promise: never silently densify a large remainder
        # (an early agg fallback or non-coarsenable axes would otherwise
        # leave an O(n^2)-memory np.linalg.inv of the FULL operator here)
        raise ValueError(
            f"rediscretized coarsening stopped at n={A_h.n} > 4*max_coarse="
            f"{4 * max_coarse} (grid {g}: axes not fw/hyb-coarsenable, or "
            "the near-null probe forced aggregation); fix the grid sizes "
            "(2^k or 2^k-1 axes) or raise max_coarse explicitly"
        )
    dt = dtype or np.asarray(A_h.data).dtype
    dense = formats.dia_to_dense(A_h)
    coarse_inv = jnp.asarray(np.linalg.inv(np.asarray(dense.data, dtype=np.float64)).astype(dt))
    return MgHierarchy(
        levels=tuple(levels),
        coarse_inv=coarse_inv,
        smoother=smoother,
        pre=pre,
        post=post,
        omega=omega,
    )


def _smooth(h: MgHierarchy, lvl: MgLevel, op, b, x, sweeps: int,
            post: bool = False):
    if sweeps <= 0:
        return x
    if h.smoother == "chebyshev":
        lo, hi = lvl.cheb_bounds
        return chebyshev_smooth(op, lvl.inv_diag, b, x, sweeps, hi, lo)
    if h.smoother == "rbgs":
        fn = redblack_gs_smooth_reversed if post else redblack_gs_smooth
        return fn(op, lvl.inv_diag, b, x, sweeps, lvl.mask)
    return jacobi_smooth(op, lvl.inv_diag, b, x, sweeps, h.omega)


def _semi_mask(kind: str):
    """Decode "semi101..." -> per-axis coarsen mask."""
    return tuple(c == "1" for c in kind[len("semi"):])


def _coarse_shape_of(g: GridShape, kind: str) -> GridShape:
    if kind == "fw":
        return transfer.coarse_shape(g)
    if kind == "hyb":
        return transfer.hybrid_coarse_shape(g)
    if kind.startswith("semi"):
        return transfer.partial_coarse_shape(g, _semi_mask(kind))
    return transfer.agg_coarse_shape(g)


def _level_transfers(lvl: MgLevel, op):
    """(restrict, prolong) closures for a level, grid-shaped arrays.

    Agg levels use the smoothed-aggregation operators — exact adjoints of the
    scipy P used for the Galerkin product (symmetry = PCG validity):
    P = (I - c D^{-1}A) diag(W) P_plain, R = P^T / 2^d.
    """
    if lvl.transfer == "hyb":
        return transfer.restrict_hybrid_grid, transfer.prolong_hybrid_grid
    if lvl.transfer.startswith("semi"):
        mask = _semi_mask(lvl.transfer)
        return (
            lambda r: transfer.restrict_partial_grid(r, mask),
            lambda e, fine: transfer.prolong_partial_grid(e, fine, mask),
        )
    if lvl.transfer != "agg":
        return transfer.restrict_grid, transfer.prolong_grid
    W = lvl.weight
    if not lvl.sa_smooth:
        # plain weighted aggregation: P = diag(W) P_plain, R = P^T / 2^d —
        # exact adjoints, no operator application in the transfer
        if isinstance(lvl.A, (StencilMatrix, ConstStencilMatrix)):
            return (
                lambda r: transfer.restrict_agg_grid(W * r),
                lambda e, fine: W * transfer.prolong_agg_grid(e, fine),
            )
        return (
            lambda r: transfer.restrict_agg_grid((W * r.reshape(-1)).reshape(r.shape)),
            lambda e, fine: (W * transfer.prolong_agg_grid(e, fine).reshape(-1)).reshape(fine),
        )
    c = _SA_W / lvl.cheb_bounds[1]

    if isinstance(lvl.A, (StencilMatrix, ConstStencilMatrix)):

        def rg(r):
            return transfer.restrict_agg_grid(W * (r - c * op(lvl.inv_diag * r)))

        def pg(e, fine):
            w = W * transfer.prolong_agg_grid(e, fine)
            return w - c * (lvl.inv_diag * op(w))

    else:
        # dia layout: op / inv_diag / W are flat, but the agg transfer
        # operators are grid-shaped — flatten around them (callers pass and
        # receive grid-shaped arrays at multi-dimensional grids)

        def rg(r):
            rf = r.reshape(-1)
            s = W * (rf - c * op(lvl.inv_diag * rf))
            return transfer.restrict_agg_grid(s.reshape(r.shape))

        def pg(e, fine):
            w = W * transfer.prolong_agg_grid(e, fine).reshape(-1)
            return (w - c * (lvl.inv_diag * op(w))).reshape(fine)

    return rg, pg


def v_cycle(
    h: MgHierarchy,
    b: jnp.ndarray,
    level: int = 0,
    roll: bool = False,
    gamma: int = 1,
    x0: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """One multigrid cycle for A_level e = b (zero initial guess by default).

    ``gamma`` is the cycle index: 1 = V-cycle, 2 = W-cycle (the coarse
    correction recurses twice — stronger per-cycle contraction at ~2x coarse
    work, still cheap because levels shrink 2^d-fold).  Static recursion —
    unrolls completely at trace time.  ``roll=True`` selects the
    GSPMD-friendly cyclic-roll SpMV (see ``parallel.gspmd``).
    """
    from conjugategradient_tpu.ops.spmv import as_operator

    if level == len(h.levels):
        y = jnp.dot(h.coarse_inv, b.reshape(-1), precision=MATMUL_PRECISION,
                    preferred_element_type=b.dtype)
        return y.reshape(b.shape)
    lvl = h.levels[level]
    op = as_operator(lvl.A, roll=roll)
    grid_native = isinstance(lvl.A, (StencilMatrix, ConstStencilMatrix))
    if grid_native and tuple(b.shape) != tuple(lvl.grid):
        # flat caller with a stencil hierarchy: run grid-shaped, return flat
        x0g = None if x0 is None else x0.reshape(lvl.grid)
        return v_cycle(h, b.reshape(lvl.grid), level, roll, gamma, x0g).reshape(-1)
    x = jnp.zeros_like(b) if x0 is None else x0
    x = _smooth(h, lvl, op, b, x, h.pre)

    rg, pg = _level_transfers(lvl, op)

    def correct(x):
        r = b - op(x)
        if grid_native:
            rc = rg(r)
            ec = v_cycle(h, rc, level + 1, roll, gamma)
            return x + pg(ec, lvl.grid)
        cg_shape = _coarse_shape_of(lvl.grid, lvl.transfer)
        rc = rg(r.reshape(lvl.grid)).reshape(-1)
        ec = v_cycle(h, rc, level + 1, roll, gamma)
        return x + pg(ec.reshape(cg_shape), lvl.grid).reshape(-1)

    reps = gamma if level > 0 else 1  # cycle index applies below the top
    for _ in range(reps):
        x = correct(x)
    x = _smooth(h, lvl, op, b, x, h.post, post=True)
    return x


def fmg(h: MgHierarchy, b: jnp.ndarray, roll: bool = False) -> jnp.ndarray:
    """Full multigrid: coarsest-first solve, prolong, one V-cycle per level.

    Produces an O(discretisation-accuracy) initial guess in one pass — the
    classic O(n) solver; pair with 1-3 MGCG iterations for tolerances beyond
    truncation error.
    """
    grid_native = len(h.levels) > 0 and isinstance(h.levels[0].A, (StencilMatrix, ConstStencilMatrix))
    flat_in = grid_native and len(h.levels) > 0 and tuple(b.shape) != tuple(h.levels[0].grid)
    if flat_in:
        b = b.reshape(h.levels[0].grid)

    from conjugategradient_tpu.ops.spmv import as_operator as _as_op

    # restrict b down the hierarchy (same weighted/smoothed operators as the
    # V-cycle — consistency keeps the cascade meaningful for matrices whose
    # near-null space is not the constant)
    bs = [b]
    for lvl in h.levels:
        rg, _ = _level_transfers(lvl, _as_op(lvl.A, roll=roll))
        if grid_native:
            bs.append(rg(bs[-1]))
        else:
            bs.append(rg(bs[-1].reshape(lvl.grid)).reshape(-1))
    # coarsest: direct solve
    bc = bs[-1]
    x = jnp.dot(h.coarse_inv, bc.reshape(-1), precision=MATMUL_PRECISION,
                preferred_element_type=b.dtype).reshape(bc.shape)
    # walk up: prolong + one V-cycle with that initial guess
    for level in range(len(h.levels) - 1, -1, -1):
        lvl = h.levels[level]
        _, pg = _level_transfers(lvl, _as_op(lvl.A, roll=roll))
        if grid_native:
            x = pg(x, lvl.grid)
        else:
            cshape = _coarse_shape_of(lvl.grid, lvl.transfer)
            x = pg(x.reshape(cshape), lvl.grid).reshape(-1)
        x = v_cycle(h, bs[level], level, roll, x0=x)
    return x.reshape(-1) if flat_in else x


def as_preconditioner(
    h: MgHierarchy, roll: bool = False, gamma: int = 1
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """M(r) = one V- (gamma=1) or W- (gamma=2) cycle — the "Mg" in MGCG.
    SPD by symmetric construction, so valid for ``cg_solve(..., M=...)``."""
    return partial(v_cycle, h, level=0, roll=roll, gamma=gamma)


def mgcg_solve(
    A: DiaMatrix,
    b,
    grid: GridShape,
    x0=None,
    policy=None,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    hierarchy: Optional[MgHierarchy] = None,
    precise_dot: bool = False,
    layout: str = "stencil",
    gamma: int = 1,
):
    """Multigrid-preconditioned CG — the solver the reference's name promised.
    ``gamma=2`` runs W-cycles as the preconditioner.

    Convenience wrapper: builds (or reuses) the hierarchy, then runs the
    device-resident PCG loop with one V-cycle per iteration as M.
    Returns ``(CGResult, MgHierarchy)`` so the hierarchy can be reused across
    solves with the same sparsity (the expensive part is setup).
    """
    from conjugategradient_tpu.solvers.cg import CGResult, cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    h = hierarchy or build_hierarchy(A, grid, smoother=smoother, pre=pre, post=post, layout=layout)
    stencil = len(h.levels) > 0 and isinstance(h.levels[0].A, (StencilMatrix, ConstStencilMatrix))
    if stencil:
        A_dev = h.levels[0].A  # fine-level stencil operator (same matrix)
        b = jnp.asarray(np.asarray(b)).reshape(grid)
        x0 = None if x0 is None else jnp.asarray(np.asarray(x0)).reshape(grid)
    else:
        A_dev = A.device_put() if isinstance(A.data, np.ndarray) else A
        b = jnp.asarray(np.asarray(b))
        x0 = None if x0 is None else jnp.asarray(np.asarray(x0))
    result = cg_solve(
        A_dev,
        b,
        x0,
        policy,
        M=as_preconditioner(h, gamma=gamma),
        precise_dot=precise_dot,
    )
    if stencil:
        result = CGResult(
            x=result.x.reshape(-1),
            iterations=result.iterations,
            residual=result.residual,
            converged=result.converged,
        )
    return result, h
