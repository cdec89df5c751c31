"""Distributed multigrid setup: device-side Galerkin probing.

``precond.multigrid.build_hierarchy`` computes the coarse operators host-side
(scipy triple products) — which requires the *global* fine matrix in one
host's memory.  That caps it at ladder rung 4; the reference has the same
structural limit (its multi-GPU driver slices shards from one host-resident
system, ``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:358-379``).

This module builds the SAME hierarchy (plain weighted aggregation,
``sa_smooth=False`` — see ``build_hierarchy(sa_smooth_levels=0)``) entirely
on device from a *mesh-sharded* fine ``StencilMatrix``: no host ever holds a
global operator, so setup scales to rung 5 (100M+ rows).

How: with pairwise aggregation (``transfer.restrict_agg_grid`` /
``prolong_agg_grid``) and a fine stencil of extent <= 1 per axis, the
Galerkin coarse operator ``C = R_w A P_w`` again has extent <= 1 — its legs
live on the 3^d shift box.  Two coarse columns with the same residue mod 3
per axis are >= 3 apart, farther than the coupling extent, so **coset
probing is exact**: apply ``C`` to the 3^d indicator vectors of the residue
classes (``e_c[j] = [j === c (mod 3)]``) and read each leg off the results,

    legs[s][j] = (C e_{(j+s) mod 3})[j].

Every probe is a composition of shardable grid ops (aggregation transfers,
roll-form stencil SpMV), jitted over the mesh — XLA's SPMD partitioner
inserts the halo collectives, exactly as in the solve path
(``parallel.gspmd``).  Structurally-zero legs are pruned level by level, so
star-shaped operators (2d+1 legs) stay star-shaped all the way down.

The near-null candidate selection (constant vs checkerboard by Rayleigh
quotient), aggregate weighting, and the Chebyshev spectral bounds (power
iteration on D^{-1}A) are likewise computed on device; only O(levels)
scalars are ever read back.  The coarsest level (<= ``max_coarse`` rows) is
gathered and densely inverted — it is tiny by construction.
"""

from __future__ import annotations

from itertools import product
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.core import formats
from conjugategradient_tpu.core.formats import StencilMatrix, stencil_to_dia
from conjugategradient_tpu.ops.stencil import spmv_stencil_roll
from conjugategradient_tpu.precond import transfer
from conjugategradient_tpu.precond.multigrid import MgHierarchy, MgLevel
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION

GridShape = Tuple[int, ...]


def _box_shifts(extents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """The full per-axis shift box prod_ax {-e_ax..e_ax}, sorted (matches
    ``unit_shifts``'s ordering convention for the subset it covers)."""
    return tuple(sorted(product(*[range(-e, e + 1) for e in extents])))


def _iota_mod(grid: GridShape, periods: Tuple[int, ...]):
    return [
        jax.lax.broadcasted_iota(jnp.int32, grid, ax) % periods[ax]
        for ax in range(len(grid))
    ]


def _coset_mask(iotas, c: Tuple[int, ...]):
    m = None
    for ax, r in enumerate(c):
        e = iotas[ax] == r
        m = e if m is None else (m & e)
    return m


def _checkerboard(grid: GridShape, dtype):
    par = None
    for ax in range(len(grid)):
        i = jax.lax.broadcasted_iota(jnp.int32, grid, ax)
        par = i if par is None else par + i
    return jnp.where(par % 2 == 0, 1.0, -1.0).astype(dtype)


def _agg_weights_dev(z: jnp.ndarray, fine: GridShape):
    """Device twin of ``multigrid._agg_weights``: per-aggregate-normalised
    candidate -> (W, z_coarse).  ``restrict_agg_grid`` averages pairs per
    axis (odd tails zero-padded), so the aggregate SUM is ``2^d *``  it."""
    zz = z * z
    agg = transfer.restrict_agg_grid(zz) * (2.0 ** len(fine))
    nrm = jnp.sqrt(agg)
    expand = transfer.prolong_agg_grid(nrm, fine)
    ok = expand > 0
    W = jnp.where(ok, z / jnp.where(ok, expand, 1.0), 1.0)
    return W, nrm


def _near_null_dev(A: StencilMatrix):
    """Rayleigh quotients (z^T A z / z^T z) of the two global candidates
    (constant, checkerboard) — the device twin of ``multigrid._near_null``.
    Returns two scalars; the caller picks the smaller on the host."""
    ones = jnp.ones(A.grid, A.dtype)
    alt = _checkerboard(A.grid, A.dtype)

    def q(z):
        zAz = jnp.vdot(z, spmv_stencil_roll(A, z), precision=MATMUL_PRECISION)
        return zAz / jnp.vdot(z, z, precision=MATMUL_PRECISION)

    return q(ones), q(alt)


def _lam_max_dev(A: StencilMatrix, inv_diag: jnp.ndarray, iters: int = 30):
    """Power iteration for lam_max(D^{-1} A) on grid-shaped sharded arrays.

    Deterministic rough start (index-hash sine — spectrally broad, never
    A-orthogonal to the top mode in practice); matches
    ``eigen.scaled_spectrum_bounds``'s estimate up to iteration noise.
    """
    idx = None
    for ax in range(A.ndim):
        i = jax.lax.broadcasted_iota(jnp.int32, A.grid, ax)
        idx = i if idx is None else idx * A.grid[ax] + i
    v0 = jnp.sin(0.7 * idx.astype(A.dtype)) + 0.1
    v0 = v0 / jnp.sqrt(jnp.vdot(v0, v0, precision=MATMUL_PRECISION))

    def body(_, carry):
        v, lam = carry
        w = inv_diag * spmv_stencil_roll(A, v)
        lam = jnp.vdot(w, v, precision=MATMUL_PRECISION)
        nw = jnp.sqrt(jnp.vdot(w, w, precision=MATMUL_PRECISION))
        return (w / jnp.where(nw == 0, 1.0, nw), lam)

    _, lam = jax.lax.fori_loop(0, iters, body, (v0, jnp.zeros((), A.dtype)))
    return lam


def _probe_geometry(fine: GridShape, kind: str):
    """(coarse_shape, periods, extents) for coset probing.

    The coarse operator's per-axis coupling EXTENT sets the probing period:
    two coarse columns with the same residue mod p are p apart, so probing
    is exact iff p >= 2*extent + 1.  Plain aggregation and full weighting
    keep extent 1 (period 3); cell-centered interpolation has extent 2
    (period 5) — mixed hybrid axes probe with mixed periods.
    """
    if kind == "hyb":
        kinds = transfer.hybrid_kinds(fine)
        gc = transfer.hybrid_coarse_shape(fine)
        extents = tuple(2 if k == "cc" else 1 for k in kinds)
    else:
        gc = transfer.agg_coarse_shape(fine)
        extents = tuple(1 for _ in fine)
    periods = tuple(2 * e + 1 for e in extents)
    return gc, periods, extents


def _probe_coarse(legs, W, shifts: Tuple[Tuple[int, ...], ...], fine: GridShape, kind: str = "agg"):
    """Traced: the coarse legs of C = R A P by per-axis coset probing.

    ``kind``: "agg" = plain weighted aggregation (C = R_w A P_w with the
    aggregate weights ``W``); "hyb" = per-axis fw/cell-centered
    interpolation (geometric, W unused).  Periods per axis come from
    ``_probe_geometry`` (3 for extent-1 transfers, 5 for cell-centered).

    ``legs``/``W`` are (sharded) device arrays; everything inside is
    shardable grid ops, so under jit the mesh partitioning of the inputs
    carries through (GSPMD inserts the halo collectives).
    """
    d = len(fine)
    A = StencilMatrix(legs, shifts, fine)
    gc, periods, extents = _probe_geometry(fine, kind)
    iotas = _iota_mod(gc, periods)
    cosets = jnp.asarray(list(product(*[range(p) for p in periods])), dtype=jnp.int32)

    def apply_C(c):
        m = None
        for ax in range(d):
            e = iotas[ax] == c[ax]
            m = e if m is None else (m & e)
        e0 = m.astype(legs.dtype)
        if kind == "hyb":
            v = transfer.prolong_hybrid_grid(e0, fine)
            return transfer.restrict_hybrid_grid(spmv_stencil_roll(A, v))
        v = W * transfer.prolong_agg_grid(e0, fine)
        y = spmv_stencil_roll(A, v)
        return transfer.restrict_agg_grid(W * y)

    # sequential over the prod(periods) probes: peak memory = ONE fine-sized
    # apply (an unrolled loop let XLA keep all probes' intermediates live —
    # measured 20x the fine footprint at 255^3)
    Y = jax.lax.map(apply_C, cosets)  # (prod(periods), *gc)

    # legs[s][j] = Y[flat((j + s) mod p)][j]: one gather per output leg
    out = []
    for s in _box_shifts(extents):
        idx = None
        for ax in range(d):
            p_ax = periods[ax]
            r = (iotas[ax] + (s[ax] % p_ax)) % p_ax
            idx = r if idx is None else idx * p_ax + r
        out.append(jnp.take_along_axis(Y, idx[None], axis=0)[0])
    return jnp.stack(out)


def _specs_for(g: GridShape, mesh, axes: Tuple[str, ...]):
    """Shared divisibility rule — see ``parallel.mesh.specs_for_grid``."""
    from conjugategradient_tpu.parallel.mesh import specs_for_grid

    return specs_for_grid(g, mesh, axes)


def build_hierarchy_probed(
    A: StencilMatrix,
    mesh,
    axes: Tuple[str, ...] = ("x",),
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    power_iters: int = 30,
    transfer_kind: str = "auto",
) -> MgHierarchy:
    """Aggregation hierarchy from a mesh-sharded fine stencil — all device.

    Produces the hierarchy ``build_hierarchy(..., layout="stencil",
    sa_smooth_levels=0)`` would produce (identical coarse legs to fp
    round-off), but without any global host materialisation: setup memory
    per host is bounded by its own shards.  Requires fine extent <= 1 per
    axis (the probing period-3 window); plain aggregation preserves that
    invariant on every coarse level, so the whole hierarchy stays
    bounded-stencil.

    ``axes`` names the mesh axes sharding the leading grid axes; coarse
    levels whose extents stop dividing fall back to replicated (tiny by
    construction).  Only O(levels) scalars are read back to the host.
    """
    if not isinstance(A, StencilMatrix):
        raise TypeError("build_hierarchy_probed needs a StencilMatrix fine operator")
    if any(h > 1 for h in A.halo):
        raise ValueError(f"fine stencil extent {A.halo} > 1; probing window is 3^d")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unsupported smoother {smoother!r} (rbgs needs host masks)")
    from jax.sharding import NamedSharding

    def put(arr, spec):
        return jax.device_put(arr, NamedSharding(mesh, spec))

    def host_read(arr):
        """Multi-process-safe host copy of a (small) sharded array: jit an
        identity with fully-replicated output sharding — every process then
        addresses a complete copy — and read that.  A plain ``np.asarray``
        on a mesh-sharded array raises on pods (non-addressable shards)."""
        from jax.sharding import PartitionSpec as P

        rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(arr)
        return np.asarray(rep)

    g = tuple(A.grid)
    legs, shifts = A.data, A.shifts
    d = len(g)
    center = shifts.index(tuple([0] * d))

    if transfer_kind not in ("auto", "hyb", "agg"):
        raise ValueError(f"unknown transfer_kind {transfer_kind!r} (probed setup)")

    def _pick(gg, geom_ok=True):
        """``geom_ok``: the constant is the near-null candidate — required
        for the geometric hyb transfers (cf. multigrid._const_near_null);
        aggregation adapts its weights to either candidate."""
        if transfer_kind == "agg":
            return "agg" if transfer.can_aggregate(gg) else None
        if transfer_kind == "hyb":
            return "hyb" if transfer.can_hybrid(gg) else None
        if geom_ok and transfer.can_hybrid(gg) and all(
            n >= 5 for n in transfer.hybrid_coarse_shape(gg)
        ):
            return "hyb"  # ~2x fewer MGCG its than plain aggregation
        if transfer.can_aggregate(gg):
            return "agg"
        return None

    levels = []
    while (
        int(np.prod(g)) > max_coarse
        and _pick(g) is not None
        and len(levels) < max_levels - 1
    ):
        # per-shape jitted setup kernels (shapes shrink level by level, so
        # each level compiles a small program of its own; all shard via GSPMD)
        inv_diag, q_ones, q_alt, lam = jax.jit(
            lambda legs_, s=shifts, gg=g, c=center: _level_pack(legs_, s, gg, c, power_iters)
        )(legs)
        lam_f = float(lam) * 1.1
        bounds = (0.25 * lam_f, lam_f)
        z_is_ones = float(q_ones) <= float(q_alt)
        kind = _pick(g, geom_ok=z_is_ones)
        if kind is None:
            break

        W, z_c, coarse_legs = jax.jit(
            lambda legs_, s=shifts, gg=g, c=center, zo=z_is_ones, kk=kind: _level_coarsen(
                legs_, s, gg, zo, kk
            )
        )(legs)

        dspec, vspec = _specs_for(g, mesh, axes)
        levels.append(
            MgLevel(
                A=StencilMatrix(put(legs, dspec), shifts, g),
                inv_diag=put(inv_diag, vspec),
                grid=g,
                cheb_bounds=bounds,
                mask=None,
                transfer=kind,
                weight=put(W, vspec) if kind == "agg" else None,
                sa_smooth=False,
            )
        )

        # prune structurally-zero legs (host decision on tiny readbacks)
        gc, _, extents = _probe_geometry(g, kind)
        box = _box_shifts(extents)
        mags = host_read(jax.jit(lambda cl: jnp.stack([jnp.max(jnp.abs(l)) for l in cl]))(
            coarse_legs
        ))
        keep = [k for k in range(len(box)) if mags[k] > 0]
        new_shifts = tuple(box[k] for k in keep)
        cdspec, _ = _specs_for(gc, mesh, axes)
        legs = put(coarse_legs[np.asarray(keep)], cdspec)
        shifts, g = new_shifts, gc
        center = shifts.index(tuple([0] * d))

    # coarsest: tiny — gather, invert densely (one dense matvec at solve time).
    # Assemble dense straight from the legs: on very small grids distinct
    # shifts can alias the same flat DIA offset, so no DIA roundtrip.
    legs_h = host_read(legs)
    dense_c = _legs_to_dense(legs_h, shifts, g)
    coarse_inv = jnp.asarray(np.linalg.inv(dense_c.astype(np.float64)).astype(legs_h.dtype))
    from jax.sharding import PartitionSpec as P

    return MgHierarchy(
        levels=tuple(levels),
        coarse_inv=put(coarse_inv, P()),
        smoother=smoother,
        pre=pre,
        post=post,
        omega=omega,
    )


def build_hierarchy_redisc(
    grid: GridShape,
    mesh,
    slab_fn,
    axes: Tuple[str, ...] = ("x",),
    smoother: str = "jacobi",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    power_iters: int = 30,
    dtype=np.float32,
) -> MgHierarchy:
    """REDISCRETIZED mesh-sharded hierarchy: every level assembled directly
    from a closed-form generator, slab by slab, into sharded device arrays
    — no Galerkin product, no probing, no global host materialisation.

    This is the rung-5 setup path for operators whose Galerkin coarsening
    is UNSTABLE (convection-dominated transport — see
    ``generators.convection_diffusion_coarse_operator``): the probed
    builder would faithfully reproduce the divergent Galerkin coarse
    operators, so rediscretization must replace the product, and for
    geometric families it also makes setup trivially cheap (one generator
    pass per level vs 3^d probe solves).

    ``slab_fn(level, grid_l, lo0, hi0) -> (nlegs, hi0-lo0, *grid_l[1:])``
    host legs for axis-0 planes [lo0, hi0) of level ``level`` — e.g.
    ``generators.convection_diffusion_level_slab(eps)``, which bakes in the
    calibrated per-level scaling.  Transfers are the geometric hybrid
    fw/cc family (the rediscretization calibration holds for both — same
    measured per-level factors); EVEN (2^k) grids both halve cleanly and
    divide device meshes, so prefer them for genuinely sharded execution.
    Leg order must be sorted unit shifts (``parallel.rung5.unit_shifts``).
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unsupported smoother {smoother!r}")
    g = tuple(grid)
    d = len(g)
    shifts = _box_shifts(tuple([1] * d))  # sorted unit box = unit shifts
    shifts = tuple(s for s in shifts if sum(abs(c) for c in s) <= 1)
    center = shifts.index(tuple([0] * d))

    def put_legs(level, gg):
        dspec, _ = _specs_for(gg, mesh, axes)
        shape = (len(shifts),) + gg

        def cb(idx):
            lo, hi, _ = idx[1].indices(gg[0])
            return jnp.asarray(slab_fn(level, gg, lo, hi))

        return jax.make_array_from_callback(shape, NamedSharding(mesh, dspec), cb)

    levels = []
    lvl_idx = 0
    while (
        int(np.prod(g)) > max_coarse
        and transfer.can_hybrid(g)
        # >= 5 matches the host builder's hyb gate (cell-centered Galerkin
        # stencils have extent 2; tinier axes alias shifts)
        and all(n >= 5 for n in transfer.hybrid_coarse_shape(g))
        and len(levels) < max_levels - 1
    ):
        legs = put_legs(lvl_idx, g)
        inv_diag, _q1, _q2, lam = jax.jit(
            lambda legs_, s=shifts, gg=g, c=center: _level_pack(
                legs_, s, gg, c, power_iters
            )
        )(legs)
        lam_f = float(lam) * 1.1
        _dspec, vspec = _specs_for(g, mesh, axes)
        levels.append(
            MgLevel(
                A=StencilMatrix(legs, shifts, g),
                inv_diag=jax.device_put(inv_diag, NamedSharding(mesh, vspec)),
                grid=g,
                cheb_bounds=(0.25 * lam_f, lam_f),
                mask=None,
                transfer="hyb",
                weight=None,
                sa_smooth=False,
            )
        )
        g = transfer.hybrid_coarse_shape(g)
        lvl_idx += 1

    # coarsest: tiny — assemble on host, invert densely
    legs_h = np.asarray(slab_fn(lvl_idx, g, 0, g[0]))
    dense_c = _legs_to_dense(legs_h, shifts, g)
    coarse_inv = jnp.asarray(
        np.linalg.inv(dense_c.astype(np.float64)).astype(dtype)
    )
    return MgHierarchy(
        levels=tuple(levels),
        coarse_inv=jax.device_put(coarse_inv, NamedSharding(mesh, P())),
        smoother=smoother,
        pre=pre,
        post=post,
        omega=omega,
    )


def _legs_to_dense(legs_h: np.ndarray, shifts, g: GridShape) -> np.ndarray:
    """(nlegs, *g) stencil legs -> dense (n, n), exact grid-neighbour logic."""
    n = int(np.prod(g))
    idx = np.indices(g).reshape(len(g), -1)
    strides = np.cumprod([1] + list(g[:0:-1]))[::-1]
    out = np.zeros((n, n), dtype=legs_h.dtype)
    rows = np.arange(n)
    for k, sh in enumerate(shifts):
        nb = idx + np.asarray(sh)[:, None]
        valid = np.all((nb >= 0) & (nb < np.asarray(g)[:, None]), axis=0)
        cols = (nb * strides[:, None]).sum(axis=0)
        v = legs_h[k].reshape(-1)
        out[rows[valid], cols[valid]] += v[valid]
    return out


def _level_pack(legs, shifts, g, center, power_iters):
    """Traced per-level statistics: inverse diagonal, both near-null Rayleigh
    quotients, lam_max(D^{-1}A)."""
    A_ = StencilMatrix(legs, shifts, g)
    inv_d = 1.0 / legs[center]
    q1, q2 = _near_null_dev(A_)
    lam = _lam_max_dev(A_, inv_d, power_iters)
    return inv_d, q1, q2, lam


def _level_coarsen(legs, shifts, g, z_is_ones, kind):
    """Traced per-level coarsening: (aggregate weights +) probed coarse legs."""
    if kind == "hyb":
        one = jnp.ones((), legs.dtype)
        return one, one, _probe_coarse(legs, None, shifts, g, kind="hyb")
    z = jnp.ones(g, legs.dtype) if z_is_ones else _checkerboard(g, legs.dtype)
    W, z_c = _agg_weights_dev(z, g)
    coarse = _probe_coarse(legs, W, shifts, g)
    return W, z_c, coarse
