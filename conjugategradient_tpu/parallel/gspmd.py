"""GSPMD-partitioned solvers: the whole (MG)CG program jitted over a mesh.

Two distributed designs live in ``parallel``:

- ``sharded_cg`` — explicit ``shard_map``: hand-placed ``ppermute`` halos and
  ``psum`` dots, full control of the communication schedule (the re-design of
  the reference's hand-orchestrated multi-GPU path).
- this module — **GSPMD**: the solver (including the multigrid V-cycle, whose
  inter-level transfers make hand-sharding laborious) is written as plain
  jnp on global shapes, sharding is declared on the *data*, and XLA's SPMD
  partitioner derives the per-device program and inserts the collectives.
  This is the idiomatic JAX answer for complex programs — the analogue of the
  scaling-book recipe: pick a mesh, annotate shardings, let XLA do the rest.

The one formulation choice that makes GSPMD partition the banded SpMV with
*neighbor* communication instead of gathers: diagonal shifts are expressed as
``jnp.roll`` (cyclic), which partitions into a collective-permute of the
boundary slice.  Roll wraps around the global edges — and exactly there the
DIA ``data`` stores structural zeros (see ``core.formats.DiaMatrix``), so the
wrapped values are multiplied away.  Same masking trick as the ``shard_map``
path's ring halos, stated once in the storage format.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.formats import DiaMatrix
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.core.generators import LinearSystem
from conjugategradient_tpu.solvers.cg import CGResult, cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def shard_system(
    system: LinearSystem, mesh: Mesh, axis: str = "x", dtype=None
):
    """Place A (DIA), b, x0 on the mesh row-sharded (replicate where the
    length does not divide the axis — XLA then reshards as needed)."""
    num = mesh.shape[axis]
    dt = dtype or np.asarray(system.A.data).dtype

    def put_vec(v):
        v = jnp.asarray(np.asarray(v, dtype=dt))
        spec = P(axis) if v.shape[0] % num == 0 else P()
        return jax.device_put(v, NamedSharding(mesh, spec))

    data = jnp.asarray(np.asarray(system.A.data, dtype=dt))
    dspec = P(None, axis) if data.shape[1] % num == 0 else P()
    A = DiaMatrix(
        jax.device_put(data, NamedSharding(mesh, dspec)),
        system.A.offsets,
        system.A.shape,
    )
    return A, put_vec(system.b), put_vec(system.x0)


def _shard_hierarchy_and_fine(h, A_host: DiaMatrix, grid, mesh: Mesh, axes, dt):
    """Place a host-built MgHierarchy on the mesh (row/block-sharded level
    data, replicated tiny/odd levels) and return the sharded hierarchy, the
    sharded fine stencil operator, and the placement helpers.  Shared by the
    GSPMD MGCG and the GSPMD mg-preconditioned nonsymmetric solvers."""
    import dataclasses as _dc

    from conjugategradient_tpu.core.formats import ConstStencilMatrix, StencilMatrix
    from conjugategradient_tpu.parallel.mesh import specs_for_grid
    from conjugategradient_tpu.precond.multigrid import MgHierarchy

    def put(arr, spec):
        return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec))

    def specs_for(g):
        # tiny/odd coarse levels replicate — they cost nothing
        return specs_for_grid(g, mesh, axes)

    levels = []
    for lvl in h.levels:
        dspec, vspec = specs_for(lvl.grid)
        if isinstance(lvl.A, ConstStencilMatrix):
            # constant-coefficient level: coeffs are static metadata, no data
            A_sh = lvl.A
            ivspec = P() if getattr(lvl.inv_diag, "ndim", 0) == 0 else vspec
        else:
            A_sh = StencilMatrix(put(lvl.A.data, dspec), lvl.A.shifts, lvl.A.grid)
            ivspec = vspec
        levels.append(
            _dc.replace(
                lvl,
                A=A_sh,
                inv_diag=put(lvl.inv_diag, ivspec),
                mask=None if lvl.mask is None else put(lvl.mask, vspec),
                weight=None if lvl.weight is None else put(lvl.weight, vspec),
            )
        )
    h_sharded = MgHierarchy(
        levels=tuple(levels),
        coarse_inv=put(h.coarse_inv, P()),
        smoother=h.smoother,
        pre=h.pre,
        post=h.post,
        omega=h.omega,
    )

    dspec0, _vspec0 = specs_for(tuple(grid))
    if h_sharded.levels:
        fine_A = h_sharded.levels[0].A
    else:
        # below max_coarse the hierarchy is just the direct solve; build the
        # fine stencil operator separately
        from conjugategradient_tpu.core.formats import dia_to_stencil

        st = dia_to_stencil(A_host, tuple(grid)).astype(dt)
        fine_A = StencilMatrix(put(st.data, dspec0), st.shifts, st.grid)
    return h_sharded, fine_A, put, specs_for



# ---------------------------------------------------------------------------
# Module-cached jitted programs (the solvers/refine.py _jit_inner_* rule):
# a fresh jax.jit per make_* call re-traces an identical program; these are
# keyed on the static config, and the hierarchy/operator/vectors ride as
# pytree arguments (jit re-specializes on their structure/shardings).
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=64)
def _jit_gspmd_cg(policy):
    @jax.jit
    def _solve(h_, A_, b, x0):
        from conjugategradient_tpu.precond.multigrid import v_cycle

        res = cg_solve(
            as_operator(A_, roll=True), b, x0, policy,
            M=lambda r: v_cycle(h_, r, roll=True),
        )
        return CGResult(
            x=res.x.reshape(-1),
            iterations=res.iterations,
            residual=res.residual,
            converged=res.converged,
        )

    return _solve


@_functools.lru_cache(maxsize=32)
def _jit_gspmd_dd_axpy(grid):
    from conjugategradient_tpu.ops import dd

    @jax.jit
    def axpy(x_, d_x, s):
        return dd.dd_axpy(x_, s, d_x.reshape(grid))

    return axpy


@_functools.lru_cache(maxsize=64)
def _jit_gspmd_nonsym(policy, method: str, restart: int):
    from conjugategradient_tpu.precond.multigrid import v_cycle
    from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu.solvers.gmres import fgmres_solve, gmres_solve
    from conjugategradient_tpu.solvers.idr import idr_solve

    @jax.jit
    def _solve(h_, A_, b_, x0_):
        op = as_operator(A_, roll=True)
        M = lambda r: v_cycle(h_, r, roll=True)
        if method == "bicgstab":
            res = bicgstab_solve(op, b_, x0_, policy, M=M)
        elif method == "idr":
            res = idr_solve(op, b_, x0_, policy, M=M)
        elif method == "gmres":
            res = gmres_solve(op, b_, x0_, policy, M=M, restart=restart)
        else:
            res = fgmres_solve(op, b_, x0_, policy, M=M, restart=restart)
        import dataclasses as _dc

        return _dc.replace(res, x=res.x.reshape(-1))

    return _solve


def make_gspmd_mgcg(
    system: LinearSystem,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axes=("x",),
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy=None,
    axis: str = None,
):
    """Build a jitted, mesh-partitioned MGCG solver.

    Returns ``(solve, inputs)`` where ``solve(b, x0) -> CGResult`` runs the
    full multigrid-preconditioned CG as one SPMD program.  ``axes`` names one
    mesh axis per *grid* axis to shard (e.g. ``("x",)`` = 1-D row blocks,
    ``("x", "y")`` = 2-D block partition over a 2-D mesh — each device owns a
    contiguous sub-block, halos become collective-permutes on both axes).
    Levels whose extents stop dividing the mesh fall back to replicated —
    they are tiny by construction.  ``inputs = (b, x0)`` pre-placed.
    """
    from conjugategradient_tpu.core.formats import StencilMatrix
    from conjugategradient_tpu.precond import build_hierarchy
    from conjugategradient_tpu.precond.multigrid import MgHierarchy, MgLevel

    if axis is not None:  # back-compat alias
        axes = (axis,)
    axes = tuple(axes)
    dt = dtype or np.asarray(system.A.data).dtype
    h = hierarchy or build_hierarchy(
        system.A, grid, smoother=smoother, pre=pre, post=post, dtype=dt, layout="stencil"
    )

    h_sharded, fine_A, put, specs_for = _shard_hierarchy_and_fine(
        h, system.A, grid, mesh, axes, dt
    )
    _dspec0, vspec0 = specs_for(tuple(grid))
    b_dev = put(np.asarray(system.b, dtype=dt).reshape(grid), vspec0)
    x0_dev = put(np.asarray(system.x0, dtype=dt).reshape(grid), vspec0)

    # hierarchy + fine operator ride as jitted pytree ARGUMENTS — closure
    # constants are baked into the executable (hundreds of MB at 16M rows,
    # and a recompile per new matrix) — and the jitted program is
    # module-cached on the policy (_jit_gspmd_cg)
    _solve = _jit_gspmd_cg(policy)

    return lambda b, x0: _solve(h_sharded, fine_A, b, x0), (b_dev, x0_dev)


def gspmd_mgcg_solve(
    system: LinearSystem,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    **kw,
) -> CGResult:
    """One-call convenience: shard, jit, solve."""
    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    solve, (b, x0) = make_gspmd_mgcg(system, grid, mesh, policy, **kw)
    return solve(b, x0)


def make_gspmd_mg_nonsym(
    A: DiaMatrix,
    b,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    axes=("x",),
    smoother: str = "jacobi",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy=None,
    coarse_operator=None,
    restart: int = 32,
    x0=None,
    **build_kw,
):
    """Mesh-partitioned MULTIGRID-PRECONDITIONED nonsymmetric solve:
    BiCGStab / GMRES / FGMRES with the V-cycle as right preconditioner,
    the whole thing one GSPMD program.

    This is the distributed form of ``solve(method="mg_bicgstab"|...)`` —
    the explicit ``shard_map`` MGCG path cannot carry it because its
    sharding constraint (even local extents, agg/hyb transfers) excludes
    the odd fw grids that ``coarse_operator`` rediscretization requires,
    and convection-dominated operators NEED rediscretized coarse levels
    (Galerkin-of-upwind diverges from 127x127 up — see
    ``generators.convection_diffusion_coarse_operator``).  GSPMD has no
    such constraint: levels that stop dividing the mesh replicate.

    Sharding note: ``NamedSharding`` requires the sharded axis to DIVIDE
    the mesh (verified — uneven shards are rejected), so on odd (2^k - 1)
    fw grids every level replicates (correct, but unpartitioned).  For
    GENUINELY SHARDED convection-MG use an EVEN (2^k) grid: the hybrid
    cell-centered transfers carry the same calibrated rediscretization
    scaling (measured: identical 1/4-diffusion / 1/2-convection per-level
    factors for cc and fw axes), every level halves 128 -> 64 -> ... and
    keeps dividing the mesh, and the rediscretized hierarchy converges
    where Galerkin-hyb diverges (13/18/18 its at 128^2..512^2 vs divergence
    at every size).

    ``smoother`` defaults to "jacobi": the chebyshev smoother's bounds are
    estimated on a symmetrized similar operator, safe for mildly nonsym
    levels but the jacobi default is robust at any Peclet.  Returns
    ``(solve, (b, x0))`` with pre-placed inputs, like ``make_gspmd_mgcg``.
    """
    from conjugategradient_tpu.precond import build_hierarchy

    if method not in ("bicgstab", "gmres", "fgmres", "idr"):
        raise ValueError(
            f"unknown method {method!r}; want bicgstab|gmres|fgmres|idr"
        )
    axes = tuple(axes)
    dt = dtype or np.asarray(A.data).dtype
    h = hierarchy or build_hierarchy(
        A, grid, smoother=smoother, pre=pre, post=post, dtype=dt,
        layout="stencil", coarse_operator=coarse_operator, **build_kw,
    )
    h_sharded, fine_A, put, specs_for = _shard_hierarchy_and_fine(
        h, A, grid, mesh, axes, dt
    )
    _dspec0, vspec0 = specs_for(tuple(grid))
    b_dev = put(np.asarray(b, dtype=dt).reshape(grid), vspec0)
    x0_arr = np.zeros(tuple(grid), dtype=dt) if x0 is None else np.asarray(
        x0, dtype=dt
    ).reshape(grid)
    x0_dev = put(x0_arr, vspec0)

    _solve = _jit_gspmd_nonsym(policy, method, int(restart))

    return lambda b_, x0_: _solve(h_sharded, fine_A, b_, x0_), (b_dev, x0_dev)


def gspmd_mg_nonsym_solve(
    A: DiaMatrix,
    b,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    **kw,
) -> CGResult:
    """One-call convenience for the GSPMD mg-preconditioned nonsym solve."""
    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    x0 = kw.pop("x0", None)
    solve, (b_dev, x0_dev) = make_gspmd_mg_nonsym(
        A, b, grid, mesh, policy, x0=x0, **kw
    )
    return solve(b_dev, x0_dev)


def gspmd_refined_solve(
    A: DiaMatrix,
    b,
    grid,
    mesh: Optional[Mesh] = None,
    axes=("x",),
    x0=None,
    tol: float = 1e-8,
    norm: str = "l2",
    inner_tol: float = 1e-5,
    max_outer: int = 40,
    hierarchy=None,
    smoother: str = "chebyshev",
    raise_on_divergence: bool = False,
):
    """fp64-tolerance refinement, mesh-partitioned end to end: the
    reference's absolute-1e-8 contract (``Mgcg/cuBlas/Mgcg/MgcgMain.cs:29``)
    at distributed scale, with no fp64 hardware anywhere.

    Composition of two proven pieces, both partitioned by GSPMD over the
    SAME mesh so no resharding happens between them:

    - the dd (two-fp32) outer pass (``ops.dd``): residual, norm², inf-norm
      scaling — pure pads/slices/elementwise, which XLA partitions with
      neighbor exchanges only (bitwise equal to single-device; tested in
      ``tests/test_dd.py``);
    - the GSPMD MGCG inner solve (``make_gspmd_mgcg``): V-cycle + CG as one
      SPMD program.

    Per outer pass three scalars cross the host boundary (rr, mx, inner
    iteration count); vectors never leave the mesh.  The dd solution pair
    is gathered once, at the end.  Returns ``solvers.refine.RefineResult``.
    """
    from conjugategradient_tpu.core.formats import (
        StencilMatrix,
        dia_to_stencil,
        stencil_to_const,
    )
    from conjugategradient_tpu.ops import dd
    from conjugategradient_tpu.parallel.mesh import specs_for_grid
    from conjugategradient_tpu.solvers.refine import run_device_refinement

    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
    grid = tuple(grid)
    n = A.n
    b64 = np.asarray(b, dtype=np.float64)
    x64 = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64)

    inner_policy = ConvergencePolicy(
        tol=inner_tol, norm="rel_l2", max_iteration=min(8 * n, 1_000_000)
    )
    system = LinearSystem(A=A, b=b64, x0=x64)
    solve_inner, _ = make_gspmd_mgcg(
        system, grid, mesh, inner_policy, axes=axes, smoother=smoother,
        dtype=np.float32, hierarchy=hierarchy,
    )

    dspec, vspec = specs_for_grid(grid, mesh, axes)
    put = lambda arr, spec: jax.device_put(
        jnp.asarray(arr), NamedSharding(mesh, spec)
    )

    st64 = dia_to_stencil(A, grid)
    cst = stencil_to_const(st64)
    ddm = dd.dd_split_matrix(cst or st64)
    if cst is None:
        # variable coefficients: shard the hi/lo data like the fine level
        ddm = dd.DDMatrix(
            StencilMatrix(put(ddm.hi.data, dspec), ddm.hi.shifts, ddm.hi.grid),
            StencilMatrix(put(ddm.lo.data, dspec), ddm.lo.shifts, ddm.lo.grid),
        )

    b_dd = tuple(put(part, vspec) for part in dd.dd_from_f64(b64.reshape(grid)))
    x_dd = tuple(put(part, vspec) for part in dd.dd_from_f64(x64.reshape(grid)))
    zero32 = put(jnp.zeros(grid, jnp.float32), vspec)

    from conjugategradient_tpu.solvers.refine import _jit_dd_resid

    resid = _jit_dd_resid()
    axpy = _jit_gspmd_dd_axpy(tuple(grid))

    def update_fn(x_, r32, s):
        res = solve_inner(r32, zero32)
        return axpy(x_, res.x, s), res.iterations

    return run_device_refinement(
        lambda b_, x_: resid(ddm, b_, x_), update_fn, b_dd, x_dd,
        tol=tol, norm=norm, max_outer=max_outer,
        raise_on_divergence=raise_on_divergence,
    )
