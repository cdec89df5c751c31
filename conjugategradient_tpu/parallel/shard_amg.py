"""Distributed algebraic multigrid: row-sharded SA hierarchies over a mesh.

``precond.amg`` builds smoothed-aggregation hierarchies for matrices with no
grid (Matrix Market files, permuted meshes, graph Laplacians); until now the
cycle only ran single-device, and the facade refused ``amg_* + mesh=``.  This
module is the distributed carrier: every sufficiently large level is
row-block-sharded and the V-cycle runs INSIDE ``shard_map`` as the ``M`` of
the existing sharded Krylov loops (``sharded_cg_loop`` /
``sharded_bicgstab_loop`` / ``sharded_gmres_loop`` / ``sharded_minres_loop``)
— one jitted SPMD program end to end, scalars never leaving the devices.

Communication design (the unstructured-sparsity answer, the same trade the
reference's flagship makes for its general CSR case):

- every level operator (A_l), restriction (R_l = P_l^T) and prolongation
  (P_l) is stored as padded per-shard COO-ish blocks (the
  ``sharded_general._csr_shard_arrays`` layout generalised to RECTANGULAR
  matrices: rows live in this level's partition, columns index a vector
  living in the *other* level's partition);
- each SpMV first materialises the column window it needs: an exact-hop
  ``ring_gather`` of the source vector (hops from the per-shard [minJ, maxJ]
  ranges — the reference's ``Mgcg.cu:82-84`` discovery applied per level and
  per transfer), or one ``all_gather`` when the window would cover most of
  the ring anyway (the reference's global-length ``vectorP`` fallback,
  ``ConjugateGradientParallelGpu.cs:321``).  Smoothed-aggregation transfers
  are near-local (aggregates group neighbouring rows and ids are assigned in
  row order), so on banded/mesh-like problems every hop count is small;
- levels too small to shard form a REPLICATED TAIL (the ``shard_mgcg``
  pattern): one ``all_gather`` moves the residual to every shard, the tail
  cycle (a plain ``precond.amg.amg_vcycle``) runs redundantly on full
  vectors, and each shard slices its own block of the correction back out.

Sizes are made shard-divisible with identity-row padding (decoupled rows,
``x_pad = b_pad = 0`` — the ``core.partition.pad_system`` convention applied
per level): A gains unit diagonal entries, P/R gain zero rows/columns, so
padded entries stay exactly zero through smoothing, transfer and the Krylov
recurrence, and every dot/norm psum matches the unpadded values bit-for-bit
in exact arithmetic.

Collectives per V-cycle application per sharded level: one window gather per
smoother SpMV (pre + post, +1 for Chebyshev's initial residual each), one for
the coarse-grid residual, one each for R and P — honest for unstructured
sparsity; grid-structured systems should keep using the geometric carriers
(``parallel.shard_mgcg`` / ``parallel.gspmd``), whose halos are O(bandwidth)
by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.partition import RowBlockPartition, hops_from_ranges
from conjugategradient_tpu.parallel.halo import ring_gather
from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_loop
from conjugategradient_tpu.precond.amg import (
    AmgHierarchy,
    AmgLevel,
    amg_vcycle,
    build_amg_hierarchy,
)
from conjugategradient_tpu.precond.smoothers import chebyshev_smooth, jacobi_smooth
from conjugategradient_tpu.solvers.cg import CGResult
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


# ---------------------------------------------------------------------------
# host-side setup: pad, partition, rebase
# ---------------------------------------------------------------------------


def _pad_scipy(S: sp.csr_matrix, mr: int, mc: int, unit_diag: bool) -> sp.csr_matrix:
    """Grow a scipy CSR to (mr, mc); ``unit_diag`` adds 1.0 on the appended
    rows' diagonal (identity-row padding for square operators)."""
    nr, nc = S.shape
    coo = S.tocoo()
    rows, cols, data = coo.row, coo.col, coo.data
    if unit_diag and mr > nr:
        extra = np.arange(nr, mr)
        rows = np.concatenate([rows, extra])
        cols = np.concatenate([cols, extra])
        data = np.concatenate([data, np.ones(mr - nr, dtype=data.dtype)])
    return sp.csr_matrix((data, (rows, cols)), shape=(mr, mc))


def _rect_shard_arrays(
    S: sp.csr_matrix, num: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
    """Per-shard padded (data, cols, rows) blocks for a rectangular CSR whose
    rows split over ``num`` shards and whose columns index a vector split
    over ``num`` shards (both dimensions already shard-divisible).

    Returns ``(data, cols, rows, hops, use_allgather)``.  Columns are rebased
    into ring-window coordinates (``col - col_off_s + hops * nc_local``)
    unless the exact windows would cover most of the ring, in which case
    global coordinates are kept and the consumer all-gathers.  Padding
    entries keep ``segment_sum``'s sorted invariant (data 0, row =
    nr_local - 1, in-range column) — the ``sharded_general`` convention.
    """
    nr, nc = S.shape
    assert nr % num == 0 and nc % num == 0
    nr_local, nc_local = nr // num, nc // num
    row_part = RowBlockPartition.equal(nr, num)
    col_part = RowBlockPartition.equal(nc, num)
    indptr, indices, data = S.indptr, S.indices, S.data
    row_ids = np.repeat(np.arange(nr), np.diff(indptr))

    ranges = []
    for off, cnt, coff in zip(row_part.offsets, row_part.counts, col_part.offsets):
        lo, hi = int(indptr[off]), int(indptr[off + cnt])
        if hi > lo:
            c = indices[lo:hi]
            ranges.append((int(c.min()), int(c.max())))
        else:
            ranges.append((coff, coff))
    hops = hops_from_ranges(ranges, col_part)
    use_allgather = 2 * hops + 1 >= num
    pad_col = 0 if use_allgather else hops * nc_local

    spans = [(int(indptr[o]), int(indptr[o + c])) for o, c in zip(row_part.offsets, row_part.counts)]
    nnz_max = max(1, max(hi - lo for lo, hi in spans))
    data_sh = np.zeros((num, nnz_max), dtype=data.dtype)
    cols_sh = np.full((num, nnz_max), pad_col, dtype=np.int32)
    rows_sh = np.full((num, nnz_max), nr_local - 1, dtype=np.int32)
    for s, ((lo, hi), roff, coff) in enumerate(
        zip(spans, row_part.offsets, col_part.offsets)
    ):
        m = hi - lo
        data_sh[s, :m] = data[lo:hi]
        cols_sh[s, :m] = indices[lo:hi] - (0 if use_allgather else coff - hops * nc_local)
        rows_sh[s, :m] = row_ids[lo:hi] - roff
    return data_sh, cols_sh, rows_sh, hops, use_allgather


@dataclasses.dataclass(frozen=True)
class _LevelMeta:
    """Static per-level shapes/comm plan (shard_map closure constants)."""

    n_local: int  # this level's rows per shard (padded)
    nc_local: int  # next level's rows per shard (padded; tail size if last)
    hops_A: int
    ag_A: bool
    hops_R: int
    ag_R: bool
    hops_P: int
    ag_P: bool
    cheb_bounds: Tuple[float, float]


def _gathered(p, hops: int, use_ag: bool, axis: str, num: int):
    if use_ag:
        return jax.lax.all_gather(p, axis, tiled=True)
    return ring_gather(p, hops, axis, num)


def _spmv_local(mats, p_ext, n_local: int):
    data_l, cols_l, rows_l = mats
    return jax.ops.segment_sum(
        data_l[0] * p_ext[cols_l[0]],
        rows_l[0],
        num_segments=n_local,
        indices_are_sorted=True,
    )


def build_sharded_amg(
    h: AmgHierarchy,
    mesh: Mesh,
    axis: str = "x",
    min_local: int = 32,
):
    """Partition an SA hierarchy for ``mesh``: returns ``(mats, specs, metas,
    tail, n_pad)`` where ``mats`` is the flat tuple of pre-placed per-shard
    device arrays (jit arguments — nothing large in the compile payload),
    ``specs`` its matching ``PartitionSpec`` tree, ``metas`` the static
    per-level comm plans, ``tail`` the replicated coarse ``AmgHierarchy``
    (its top level padded to the gather size) and ``n_pad`` the padded fine
    size.  Levels shard while they hold at least ``min_local`` rows per
    shard; the rest replicate.
    """
    from conjugategradient_tpu.core.io import to_scipy

    num = mesh.shape[axis]
    # host scipy forms of every level (setup-time only)
    levels_h = []
    for lvl in h.levels:
        levels_h.append(
            (
                to_scipy(lvl.A).tocsr(),
                to_scipy(lvl.P).tocsr(),
                # stencil-relayouted ND levels store inv_diag grid-shaped
                np.asarray(lvl.inv_diag).reshape(-1),
                lvl.cheb_bounds,
            )
        )

    # how many levels to shard
    t = 0
    while t < len(levels_h) and levels_h[t][0].shape[0] >= min_local * num:
        t += 1

    pad = lambda n: ((n + num - 1) // num) * num
    sizes = [A_h.shape[0] for A_h, _, _, _ in levels_h] + [h.coarse_inv.shape[0]]
    padded = [pad(s) for s in sizes[: t + 1]] + sizes[t + 1 :]

    mats, specs, metas = [], [], []
    shard2d = NamedSharding(mesh, P(axis, None))
    row = NamedSharding(mesh, P(axis))
    for l in range(t):
        A_h, P_h, invd, bounds = levels_h[l]
        m_l, m_c = padded[l], padded[l + 1]
        A_p = _pad_scipy(A_h, m_l, m_l, unit_diag=True)
        P_p = _pad_scipy(P_h, m_l, m_c, unit_diag=False)
        dA = _rect_shard_arrays(A_p, num)
        dR = _rect_shard_arrays(P_p.T.tocsr(), num)
        dP = _rect_shard_arrays(P_p, num)
        invd_p = np.concatenate([invd, np.ones(m_l - len(invd), dtype=invd.dtype)])
        for d, c, r, _, _ in (dA, dR, dP):
            mats += [
                jax.device_put(jnp.asarray(d), shard2d),
                jax.device_put(jnp.asarray(c), shard2d),
                jax.device_put(jnp.asarray(r), shard2d),
            ]
            specs += [P(axis, None)] * 3
        mats.append(jax.device_put(jnp.asarray(invd_p), row))
        specs.append(P(axis))
        metas.append(
            _LevelMeta(
                n_local=m_l // num,
                nc_local=m_c // num,
                hops_A=dA[3], ag_A=dA[4],
                hops_R=dR[3], ag_R=dR[4],
                hops_P=dP[3], ag_P=dP[4],
                cheb_bounds=bounds,
            )
        )

    # replicated tail: pad its top to the gather size
    m_t = padded[t]
    if t == len(levels_h):
        ci = np.asarray(h.coarse_inv)
        nc = ci.shape[0]
        if m_t > nc:
            ci_p = np.eye(m_t, dtype=ci.dtype)
            ci_p[:nc, :nc] = ci
        else:
            ci_p = ci
        tail = AmgHierarchy(
            levels=(), coarse_inv=jnp.asarray(ci_p), smoother=h.smoother,
            pre=h.pre, post=h.post, omega=h.omega,
        )
    else:
        A_h, P_h, invd, bounds = levels_h[t]
        n_t = A_h.shape[0]
        from conjugategradient_tpu.core.io import from_scipy

        dt = np.asarray(invd).dtype
        A_p = _pad_scipy(A_h, m_t, m_t, unit_diag=True)
        P_p = _pad_scipy(P_h, m_t, P_h.shape[1], unit_diag=False)
        top = AmgLevel(
            A=from_scipy(A_p).device_put(dtype=dt),
            P=from_scipy(P_p).device_put(dtype=dt),
            R=from_scipy(P_p.T.tocsr()).device_put(dtype=dt),
            inv_diag=jnp.asarray(
                np.concatenate([invd, np.ones(m_t - n_t, dtype=invd.dtype)])
            ),
            cheb_bounds=bounds,
        )
        tail = dataclasses.replace(h, levels=(top,) + h.levels[t + 1 :])

    return tuple(mats), tuple(specs), tuple(metas), tail, padded[0]


def _make_local_vcycle(
    metas: Tuple[_LevelMeta, ...],
    h_static: AmgHierarchy,
    axis: str,
    num: int,
    gamma: int = 1,
):
    """Returns ``vcycle(mats, tail, r_local) -> e_local`` — the shard-local
    SA cycle (collectives inside), the ``M`` of the sharded Krylov loops."""

    def smooth(meta, opl, invd_l, b, x, sweeps, smoother, omega):
        if sweeps <= 0:
            return x
        if smoother == "chebyshev":
            lo, hi = meta.cheb_bounds
            return chebyshev_smooth(opl, invd_l, b, x, sweeps, hi, lo)
        return jacobi_smooth(opl, invd_l, b, x, sweeps, omega)

    def vcycle(mats, tail, r_local):
        def level_ops(l):
            base = 10 * l
            mA = mats[base : base + 3]
            mR = mats[base + 3 : base + 6]
            mP = mats[base + 6 : base + 9]
            invd_l = mats[base + 9]
            meta = metas[l]
            opA = lambda p: _spmv_local(
                mA, _gathered(p, meta.hops_A, meta.ag_A, axis, num), meta.n_local
            )
            opR = lambda p: _spmv_local(
                mR, _gathered(p, meta.hops_R, meta.ag_R, axis, num), meta.nc_local
            )
            opP = lambda p: _spmv_local(
                mP, _gathered(p, meta.hops_P, meta.ag_P, axis, num), meta.n_local
            )
            return meta, opA, opR, opP, invd_l

        def cyc(l, b):
            if l == len(metas):
                b_full = jax.lax.all_gather(b, axis, tiled=True)
                # the tail TOP's repetition is the sharded caller's loop;
                # gamma must still ride into the tail's own sub-levels so
                # W-cycles match the single-device amg_vcycle exactly
                e_full = amg_vcycle(tail, b_full, gamma=gamma)
                i = jax.lax.axis_index(axis)
                return jax.lax.dynamic_slice_in_dim(
                    e_full, i * b.shape[0], b.shape[0]
                )
            meta, opA, opR, opP, invd_l = level_ops(l)
            x = smooth(
                meta, opA, invd_l, b, jnp.zeros_like(b), h_static.pre,
                h_static.smoother, h_static.omega,
            )
            for _ in range(gamma if l > 0 else 1):
                rc = opR(b - opA(x))
                ec = cyc(l + 1, rc)
                x = x + opP(ec)
            return smooth(
                meta, opA, invd_l, b, x, h_static.post,
                h_static.smoother, h_static.omega,
            )

        return cyc(0, r_local)

    return vcycle


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def make_sharded_amg(
    h: AmgHierarchy,
    n: int,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "cg",
    axis: str = "x",
    gamma: int = 1,
    min_local: int = 32,
    restart: int = 32,
):
    """Build the jitted sharded AMG-preconditioned solver for an ``n``-row
    system: returns ``(solve, mats_and_tail, n_pad)`` with
    ``solve(mats_and_tail, b_pad, x0_pad) -> CGResult`` on row-sharded
    padded vectors (a plain jitted function — ``solve.lower(mats_and_tail,
    b_pad, x0_pad)`` for HLO inspection; ``solve.mesh_axis`` records the
    mesh axis)."""
    from conjugategradient_tpu.parallel.shard_nonsym import (
        sharded_bicgstab_loop,
        sharded_gmres_loop,
        sharded_minres_loop,
    )

    if method not in ("cg", "bicgstab", "gmres", "fgmres", "minres"):
        raise ValueError(f"unknown method {method!r}")
    num = mesh.shape[axis]
    mats, specs, metas, tail, n_pad = build_sharded_amg(
        h, mesh, axis=axis, min_local=min_local
    )

    # fine operator from level 0's shard arrays (or the tail A if the whole
    # hierarchy replicated — degenerate but legal on tiny systems)
    if metas:
        meta0 = metas[0]

        def fine_op_of(mats_t, tail_t):
            mA = mats_t[0:3]
            return lambda p: _spmv_local(
                mA, _gathered(p, meta0.hops_A, meta0.ag_A, axis, num), meta0.n_local
            )

    else:
        if not tail.levels:
            raise ValueError(
                f"system too small to distribute (n <= max_coarse and "
                f"< {min_local} rows/shard); solve single-device"
            )
        from conjugategradient_tpu.ops.spmv import spmv_csr

        def fine_op_of(mats_t, tail_t):
            def op(p):
                p_full = jax.lax.all_gather(p, axis, tiled=True)
                # matrix from the PASSED pytree, never a closure constant
                # (closure constants are baked into the compiled program)
                y = spmv_csr(tail_t.levels[0].A, p_full)
                i = jax.lax.axis_index(axis)
                return jax.lax.dynamic_slice_in_dim(y, i * p.shape[0], p.shape[0])

            return op

    vcycle = _make_local_vcycle(metas, h, axis, num, gamma=gamma)

    def local_solve(mats_and_tail, b_l, x0_l):
        mats_t, tail_t = mats_and_tail
        op = fine_op_of(mats_t, tail_t)
        M = lambda r: vcycle(mats_t, tail_t, r)
        if method == "cg":
            return sharded_cg_loop(op, M, b_l, x0_l, policy, axis, n)
        if method == "bicgstab":
            return sharded_bicgstab_loop(op, M, b_l, x0_l, policy, axis, n)
        if method == "minres":
            return sharded_minres_loop(op, M, b_l, x0_l, policy, axis, n)
        return sharded_gmres_loop(
            op, M, b_l, x0_l, policy, axis, n, restart=restart,
            flexible=(method == "fgmres"),
        )

    tail_specs = jax.tree.map(lambda _: P(), tail)
    row_spec = P(axis)
    shard_fn = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=((specs, tail_specs), row_spec, row_spec),
        out_specs=CGResult(x=row_spec, iterations=P(), residual=P(), converged=P()),
    )
    solve = jax.jit(shard_fn)
    solve.mesh_axis = axis
    return solve, (mats, tail), n_pad


def sharded_amg_solve(
    A,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "cg",
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    hierarchy: Optional[AmgHierarchy] = None,
    gamma: int = 1,
    min_local: int = 32,
    restart: int = 32,
    dtype=None,
    **setup_kw,
) -> Tuple[CGResult, AmgHierarchy]:
    """Row-block-sharded AMG-preconditioned solve — ``amg_cg`` /
    ``amg_bicgstab`` / ``amg_gmres`` / ``amg_fgmres`` / ``amg_minres`` over
    a device mesh.

    ``A``: any ``core.formats`` matrix or scipy sparse (no grid needed).
    The hierarchy (host SA setup, ``precond.amg.build_amg_hierarchy``) is
    built here unless passed in; it is returned for reuse across solves.
    The fine system is identity-padded to shard divisibility internally and
    the solution sliced back — callers never pad.
    """
    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis=axis)
    b_h = np.asarray(b)
    dt = np.dtype(dtype) if dtype is not None else b_h.dtype
    if hierarchy is None:
        if method in ("bicgstab", "gmres", "fgmres"):
            setup_kw.setdefault("smoother", "jacobi")
        hierarchy = build_amg_hierarchy(A, dtype=dt, **setup_kw)
    h = hierarchy
    n = b_h.shape[0]
    solve, mats_and_tail, n_pad = make_sharded_amg(
        h, n, mesh, policy, method=method, axis=axis, gamma=gamma,
        min_local=min_local, restart=restart,
    )
    row = NamedSharding(mesh, P(axis))
    b_pad = np.zeros(n_pad, dtype=dt)
    b_pad[:n] = b_h.astype(dt)
    x0_pad = np.zeros(n_pad, dtype=dt)
    if x0 is not None:
        x0_pad[:n] = np.asarray(x0, dtype=dt)
    b_dev = jax.device_put(jnp.asarray(b_pad), row)
    x0_dev = jax.device_put(jnp.asarray(x0_pad), row)
    res = solve(mats_and_tail, b_dev, x0_dev)
    if n_pad != n:
        res = dataclasses.replace(res, x=res.x[:n])
    return res, h
