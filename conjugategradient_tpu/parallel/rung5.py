"""Rung-5 data path: sharded assembly of grid-stencil Poisson systems.

BASELINE.md's ladder rung 5 is a ~100M-row Poisson MGCG across hosts.  The
naive assembly materialises the global system on every host.  Here the
fine system is generated *directly into mesh-sharded device arrays*:
``jax.make_array_from_callback`` asks each process for the axis-0 slabs
its own devices hold, and the closed-form stencil generator
produces exactly those slabs — no host ever sees more than its shards.

Grids are identity-padded along axis 0 to the mesh size (a plane of
decoupled ``A[i,i]=1`` rows — the grid analogue of ``partition.pad_system``),
because ``NamedSharding`` needs even divisibility and the canonical 2^k-1
multigrid sizes are odd.  The padded plane solves trivially and exactly.

The hierarchy for the MGCG variant is built by ``precond.distributed`` —
device-side Galerkin probing, also without global materialisation.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.formats import StencilMatrix

GridShape = Tuple[int, ...]


def unit_shifts(d: int) -> Tuple[Tuple[int, ...], ...]:
    """Center + one ± leg per axis, sorted by flat offset (matches
    ``dia_to_stencil``'s ordering for the Poisson matrices)."""
    shifts = [tuple(0 for _ in range(d))]
    for ax in range(d):
        for s in (-1, 1):
            t = [0] * d
            t[ax] = s
            shifts.append(tuple(t))
    return tuple(sorted(shifts))


def poisson_stencil_slab(
    grid: GridShape, lo: int, hi: int, dtype=np.float32
) -> np.ndarray:
    """Stencil legs ``(nlegs, hi-lo, *grid[1:])`` for the axis-0 slab
    [lo, hi) of the identity-padded Poisson grid (Dirichlet, unit spacing;
    the closed forms of ``core.generators.poisson*_matrix``, evaluated only
    on the requested slab)."""
    d = len(grid)
    g0 = grid[0]
    shifts = unit_shifts(d)
    coords = [np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * (d - 1))]
    for ax in range(1, d):
        shp = [1] * d
        shp[ax] = grid[ax]
        coords.append(np.arange(grid[ax], dtype=np.int64).reshape(shp))
    real = coords[0] < g0
    slab_shape = (hi - lo,) + tuple(grid[1:])
    legs = np.zeros((len(shifts),) + slab_shape, dtype=dtype)
    for k, s in enumerate(shifts):
        if all(v == 0 for v in s):
            legs[k] = np.where(real, 2.0 * d, 1.0)
            continue
        ax = next(a for a, v in enumerate(s) if v)
        size = g0 if ax == 0 else grid[ax]
        nb = coords[ax] + s[ax]
        ok = real & (nb >= 0) & (nb < size)
        legs[k] = np.where(ok, -1.0, 0.0)
    return legs


def poisson_rhs_slab(
    grid: GridShape, lo: int, hi: int, dtype=np.float32, seed: int = 0
) -> np.ndarray:
    """Grid-shaped RHS slab: the ``poisson_system`` recipe on real rows
    (flat index over the ORIGINAL grid), zero on the padded plane."""
    d = len(grid)
    g0 = grid[0]
    strides = np.cumprod((1,) + tuple(grid[:0:-1]))[::-1]  # row-major strides
    coords = [np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * (d - 1))]
    for ax in range(1, d):
        shp = [1] * d
        shp[ax] = grid[ax]
        coords.append(np.arange(grid[ax], dtype=np.int64).reshape(shp))
    i = sum(coords[ax] * int(strides[ax]) for ax in range(d)).astype(np.float64)
    vals = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return np.where(coords[0] < g0, vals, 0.0).astype(dtype)


def make_rung5_system(
    grid: GridShape, mesh: Mesh, axis: str = "x", dtype=np.float32, seed: int = 0
):
    """Sharded Poisson fine system: returns ``(A, b, x0, padded_grid, n_real)``
    where ``A`` is a ``StencilMatrix`` whose legs are a mesh-sharded device
    array and ``b``/``x0`` are sharded grid-shaped device arrays — assembled
    slab by slab, never globally."""
    num = mesh.shape[axis]
    g0 = grid[0]
    G0 = ((g0 + num - 1) // num) * num
    pad0 = G0 - g0
    padded = (G0,) + tuple(grid[1:])
    d = len(grid)
    shifts = unit_shifts(d)

    leg_spec = NamedSharding(mesh, P(None, axis, *([None] * (d - 1))))
    vec_spec = NamedSharding(mesh, P(axis, *([None] * (d - 1))))

    def leg_cb(idx):
        lo, hi, _ = idx[1].indices(G0)
        return jnp.asarray(poisson_stencil_slab(grid, lo, hi, dtype=dtype))

    def b_cb(idx):
        lo, hi, _ = idx[0].indices(G0)
        return jnp.asarray(poisson_rhs_slab(grid, lo, hi, dtype=dtype, seed=seed))

    def x0_cb(idx):
        lo, hi, _ = idx[0].indices(G0)
        return jnp.zeros((hi - lo,) + tuple(grid[1:]), dtype=dtype)

    legs = jax.make_array_from_callback((len(shifts),) + padded, leg_spec, leg_cb)
    b = jax.make_array_from_callback(padded, vec_spec, b_cb)
    x0 = jax.make_array_from_callback(padded, vec_spec, x0_cb)
    return StencilMatrix(legs, shifts, padded), b, x0, padded, int(np.prod(grid))


def make_convection_system(
    grid: GridShape,
    mesh: Mesh,
    eps: float = 0.05,
    velocity="recirculating",
    scheme: str = "upwind",
    axis: str = "x",
    dtype=np.float32,
    seed: int = 0,
):
    """Sharded convection-diffusion fine system for the nonsym rung-5 path.

    EVEN-extent grids only (asserted): they both divide the mesh (no
    identity padding needed, unlike the odd Poisson grids) and halve
    cleanly under the cell-centered transfers that the REDISCRETIZED
    hierarchy (``precond.distributed.build_hierarchy_redisc``) uses —
    Galerkin coarsening diverges on this operator family, so the probed
    builder is not an option here.  Returns ``(A, b, x0)``, all
    mesh-sharded, assembled slab by slab.
    """
    grid = tuple(grid)
    num = mesh.shape[axis]
    if grid[0] % num:
        raise ValueError(f"grid[0]={grid[0]} must divide the mesh ({num})")
    if any(n % 2 for n in grid):
        raise ValueError(f"even extents required for cc coarsening, got {grid}")
    from conjugategradient_tpu.core.generators import (
        convection_diffusion_level_slab,
        convection_diffusion_rhs_slab,
    )

    d = len(grid)
    shifts = unit_shifts(d)
    slab = convection_diffusion_level_slab(
        eps, velocity=velocity, scheme=scheme, dtype=dtype
    )
    leg_spec = NamedSharding(mesh, P(None, axis, *([None] * (d - 1))))
    vec_spec = NamedSharding(mesh, P(axis, *([None] * (d - 1))))

    def leg_cb(idx):
        lo, hi, _ = idx[1].indices(grid[0])
        return jnp.asarray(slab(0, grid, lo, hi))

    def b_cb(idx):
        lo, hi, _ = idx[0].indices(grid[0])
        return jnp.asarray(
            convection_diffusion_rhs_slab(grid, lo, hi, dtype=dtype, seed=seed)
        )

    def x0_cb(idx):
        lo, hi, _ = idx[0].indices(grid[0])
        return jnp.zeros((hi - lo,) + grid[1:], dtype=dtype)

    legs = jax.make_array_from_callback((len(shifts),) + grid, leg_spec, leg_cb)
    b = jax.make_array_from_callback(grid, vec_spec, b_cb)
    x0 = jax.make_array_from_callback(grid, vec_spec, x0_cb)
    return StencilMatrix(legs, shifts, grid), b, x0


def make_rung5_mg_nonsym(policy, hierarchy, method: str = "bicgstab", restart: int = 32):
    """Jitted sharded mg-preconditioned nonsym solve at rung-5 scale:
    ``solve(b, x0) -> CGResult``; the fine operator IS
    ``hierarchy.levels[0].A`` and the (rediscretized) hierarchy rides as a
    pytree argument."""
    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.precond.multigrid import v_cycle
    from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu.solvers.gmres import fgmres_solve, gmres_solve

    if method not in ("bicgstab", "gmres", "fgmres"):
        raise ValueError(f"unknown method {method!r}")
    if not hierarchy.levels:
        raise ValueError(
            "hierarchy has no levels (grid <= max_coarse — the dense "
            "inverse IS the solve); lower max_coarse or solve directly"
        )

    @jax.jit
    def _solve(h, b, x0):
        op = as_operator(h.levels[0].A, roll=True)
        M = lambda r: v_cycle(h, r, roll=True)
        if method == "bicgstab":
            return bicgstab_solve(op, b, x0, policy, M=M)
        if method == "gmres":
            return gmres_solve(op, b, x0, policy, M=M, restart=restart)
        return fgmres_solve(op, b, x0, policy, M=M, restart=restart)

    return lambda b, x0: _solve(hierarchy, b, x0)


def make_rung5_cg(policy):
    """Jitted sharded plain CG: ``solve(A, b, x0) -> CGResult``, one GSPMD
    program, everything a pytree argument (never a closure constant —
    constants are baked into the compiled program)."""
    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.solvers.cg import cg_solve

    @jax.jit
    def _solve(A, b, x0):
        return cg_solve(as_operator(A, roll=True), b, x0, policy)

    return _solve


def make_rung5_mgcg(policy, hierarchy):
    """Jitted sharded MGCG: ``solve(b, x0) -> CGResult``.  The fine operator
    IS ``hierarchy.levels[0].A`` (no duplicate fine legs in HBM); the probed
    hierarchy (``precond.distributed.build_hierarchy_probed``) rides as a
    pytree argument."""
    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.precond.multigrid import v_cycle
    from conjugategradient_tpu.solvers.cg import cg_solve

    @jax.jit
    def _solve(h, b, x0):
        op = as_operator(h.levels[0].A, roll=True)
        return cg_solve(op, b, x0, policy, M=lambda r: v_cycle(h, r, roll=True))

    return lambda b, x0: _solve(hierarchy, b, x0)
