"""General-sparsity sharded CG: exact halo ranges over CSR / ELL row blocks.

The DIA solver (``parallel.sharded_cg``) gets its halo width from the band
structure.  The reference's flagship path is more general: each shard
discovers the exact column window [minJ, maxJ] its rows touch at init time
(``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:82-84``) and exchanges only that window per
iteration (``ConjugateGradientParallelGpu.cs:384-419``), falling back to a
global-length ``vectorP`` (:321) when the window is the whole vector.

This module is the device-mesh re-design of that general case:

- the exact ranges are computed on host at partition time
  (``core.partition.halo_ranges_from_csr`` — the native twin is
  ``csrkit_halo_ranges``), and distilled into ``hops``: how many shards away
  the window reaches (``core.partition.halo_hops``);
- per-shard CSR/ELL blocks are padded to uniform size and their column
  indices *rebased* into the coordinates of a ``(2*hops+1) * n_local`` ring
  window (``parallel.halo.ring_gather`` — ``hops`` cyclic ``ppermute`` pairs,
  the multi-hop generalisation of the reference's rank±1 exchange);
- when the window would cover most of the ring (``2*hops+1 >= num_shards``)
  the solver switches to one ``all_gather`` per SpMV with *global* column
  coordinates — the reference's ``vectorP`` worst case, minus the host
  staging;
- everything runs inside one jitted ``shard_map`` program reusing
  ``sharded_cg.sharded_cg_loop`` (psum dots, on-device convergence).  The
  CSR ring path uses the halo-OVERLAP formulation: nonzeros are split at
  setup into interior entries (columns in the shard's own block — their
  segment-sum has no data dependence on the ring) and boundary entries
  (consumed against the ``ring_gather`` window), the row-split twin of
  ``halo.spmv_dia_local_overlap``.

The per-shard index arrays ride as sharded jit *arguments*, so nothing large
lands in the compile payload.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core.formats import CsrMatrix, EllMatrix
from conjugategradient_tpu.core.partition import RowBlockPartition, halo_hops
from conjugategradient_tpu.parallel.halo import ring_gather
from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_loop
from conjugategradient_tpu.solvers.cg import CGResult
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def _ell_hops(A: EllMatrix, part: RowBlockPartition) -> int:
    """halo_hops for ELL: per-shard column ranges straight from ``cols``
    (padding slots point at the row's own index — always in-shard, harmless);
    the hop arithmetic is the shared ``partition.hops_from_ranges``."""
    from conjugategradient_tpu.core.partition import hops_from_ranges

    cols = np.asarray(A.cols)
    ranges = []
    for off, cnt in zip(part.offsets, part.counts):
        c = cols[off : off + cnt]
        ranges.append((int(c.min()), int(c.max())))
    return hops_from_ranges(ranges, part)


def _csr_shard_arrays(A: CsrMatrix, part: RowBlockPartition, hops: int, rebase: bool):
    """Uniform per-shard (data, cols, rows) blocks, padded to the max shard nnz.

    ``rebase=True`` shifts columns into ring-window coordinates
    (``col - shard_offset + hops * n_local``); ``rebase=False`` keeps global
    coordinates (the all-gather path).  Padding entries carry data == 0,
    row == n_local - 1 (keeps ``segment_sum``'s sorted invariant: real CSR
    rows ascend and never exceed it) and an in-range column.
    """
    num, n_local = part.num_shards, part.counts[0]
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    row_ids = np.asarray(A.row_ids)
    data = np.asarray(A.data)
    spans = [(int(indptr[o]), int(indptr[o + c])) for o, c in zip(part.offsets, part.counts)]
    nnz_max = max(hi - lo for lo, hi in spans)
    pad_col = hops * n_local if rebase else 0
    data_sh = np.zeros((num, nnz_max), dtype=data.dtype)
    cols_sh = np.full((num, nnz_max), pad_col, dtype=np.int32)
    rows_sh = np.full((num, nnz_max), n_local - 1, dtype=np.int32)
    for s, ((lo, hi), off) in enumerate(zip(spans, part.offsets)):
        m = hi - lo
        data_sh[s, :m] = data[lo:hi]
        cols_sh[s, :m] = indices[lo:hi] + ((hops * n_local - off) if rebase else 0)
        rows_sh[s, :m] = row_ids[lo:hi] - off
    return data_sh, cols_sh, rows_sh


def _csr_shard_arrays_overlap(A: CsrMatrix, part: RowBlockPartition, hops: int):
    """Entry-split shard arrays for the halo-OVERLAP CSR SpMV.

    Every nonzero lands in exactly one of two sets (so the matrix stream is
    not duplicated):

    - *interior* entries — column inside this shard's own block; stored with
      LOCAL column coordinates and consumed against the local ``p`` only, so
      their (dominant) segment-sum carries no data dependence on the ring
      collectives;
    - *boundary* entries — column in a neighbor's block; stored in
      ring-window coordinates and consumed against the ``ring_gather``
      result.

    The row-split twin of ``halo.spmv_dia_local_overlap`` (SURVEY §7 hard
    part 6): XLA's latency-hiding scheduler is free to run the ppermute ring
    underneath the interior compute.  Both sets keep the identity padding
    convention of ``_csr_shard_arrays`` (data 0, row n_local - 1, in-range
    column), and row order within each set stays ascending (a subsequence of
    the CSR order), preserving ``segment_sum``'s sorted invariant.
    """
    num, n_local = part.num_shards, part.counts[0]
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    row_ids = np.asarray(A.row_ids)
    data = np.asarray(A.data)
    per_shard = []
    for off, cnt in zip(part.offsets, part.counts):
        lo, hi = int(indptr[off]), int(indptr[off + cnt])
        c = indices[lo:hi]
        local = (c >= off) & (c < off + n_local)
        per_shard.append(
            (
                (data[lo:hi][local], c[local] - off, row_ids[lo:hi][local] - off),
                (
                    data[lo:hi][~local],
                    c[~local] - off + hops * n_local,
                    row_ids[lo:hi][~local] - off,
                ),
            )
        )
    out = []
    for which, pad_col in ((0, 0), (1, hops * n_local)):
        nnz_max = max(1, max(len(ps[which][0]) for ps in per_shard))
        d = np.zeros((num, nnz_max), dtype=data.dtype)
        cc = np.full((num, nnz_max), pad_col, dtype=np.int32)
        rr = np.full((num, nnz_max), n_local - 1, dtype=np.int32)
        for s, ps in enumerate(per_shard):
            dv, cv, rv = ps[which]
            m = len(dv)
            d[s, :m], cc[s, :m], rr[s, :m] = dv, cv, rv
        out.append((d, cc, rr))
    return out[0], out[1]


def make_sharded_cg_general(
    A,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    M_local: Optional[Callable] = None,
    donate: bool = False,
    variant: str = "cg",
):
    """Build a jitted sharded CG for a CSR or ELL matrix with exact halos.

    Returns ``(solve, inputs)``: ``solve(*inputs, b, x0[, m_aux]) -> CGResult``
    where ``inputs`` are the pre-placed per-shard matrix arrays (pass them
    back verbatim; they are jit arguments so re-solves with new values and
    identical sparsity reuse the compiled program).  ``b``/``x0`` must be
    row-sharded ``(n,)`` arrays (``NamedSharding(mesh, P(axis))``); use
    ``sharded_cg_solve_general`` for one-call placement.

    Requires ``A.n % num_shards == 0``.
    """
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards")
    part = RowBlockPartition.equal(n, num)
    n_local = n // num

    if isinstance(A, EllMatrix):
        hops = _ell_hops(A, part)
    elif isinstance(A, CsrMatrix):
        hops = halo_hops(A, part)
    else:
        raise TypeError(f"make_sharded_cg_general wants CsrMatrix or EllMatrix, got {type(A)}")
    # ring window vs all-gather: the ring moves 2*hops*n_local floats/iter,
    # the gather (num-1)*n_local — prefer the gather once the ring would
    # replicate most of the vector anyway
    use_allgather = 2 * hops + 1 >= num
    row_spec = P(axis)

    if isinstance(A, EllMatrix):
        cols = np.asarray(A.cols, dtype=np.int32).copy()
        if not use_allgather:
            for off, cnt in zip(part.offsets, part.counts):
                cols[off : off + cnt] += hops * n_local - off
        mat_inputs = (
            jax.device_put(jnp.asarray(A.data), NamedSharding(mesh, P(axis, None))),
            jax.device_put(jnp.asarray(cols), NamedSharding(mesh, P(axis, None))),
        )

        def local_op(mats):
            data_l, cols_l = mats

            def op(p):
                p_ext = (
                    jax.lax.all_gather(p, axis, tiled=True)
                    if use_allgather
                    else ring_gather(p, hops, axis, num)
                )
                return (data_l * p_ext[cols_l]).sum(axis=1)

            return op

    elif use_allgather:
        data_sh, cols_sh, rows_sh = _csr_shard_arrays(A, part, hops, rebase=False)
        shard2d = NamedSharding(mesh, P(axis, None))
        mat_inputs = (
            jax.device_put(jnp.asarray(data_sh), shard2d),
            jax.device_put(jnp.asarray(cols_sh), shard2d),
            jax.device_put(jnp.asarray(rows_sh), shard2d),
        )

        def local_op(mats):
            data_l, cols_l, rows_l = mats

            def op(p):
                p_ext = jax.lax.all_gather(p, axis, tiled=True)
                prods = data_l[0] * p_ext[cols_l[0]]
                return jax.ops.segment_sum(
                    prods, rows_l[0], num_segments=n_local, indices_are_sorted=True
                )

            return op

    else:
        # halo-overlap formulation: interior entries (columns in this shard's
        # own block) have no data dependence on the ring, so their dominant
        # segment-sum overlaps the ppermutes (see _csr_shard_arrays_overlap)
        (d_int, c_int, r_int), (d_bnd, c_bnd, r_bnd) = _csr_shard_arrays_overlap(
            A, part, hops
        )
        shard2d = NamedSharding(mesh, P(axis, None))
        mat_inputs = tuple(
            jax.device_put(jnp.asarray(a), shard2d)
            for a in (d_int, c_int, r_int, d_bnd, c_bnd, r_bnd)
        )

        def local_op(mats):
            di, ci, ri, db, cb, rb = mats

            def op(p):
                y_int = jax.ops.segment_sum(
                    di[0] * p[ci[0]], ri[0], num_segments=n_local, indices_are_sorted=True
                )
                p_ext = ring_gather(p, hops, axis, num)
                y_bnd = jax.ops.segment_sum(
                    db[0] * p_ext[cb[0]], rb[0], num_segments=n_local, indices_are_sorted=True
                )
                return y_int + y_bnd

            return op

    def local_solve(*args):
        if M_local is not None:
            *mats, b, x0, m_aux = args
        else:
            *mats, b, x0 = args
            m_aux = None
        op = local_op(tuple(mats))
        M = (lambda r: M_local(r, m_aux)) if M_local is not None else (lambda r: r)
        return sharded_cg_loop(op, M, b, x0, policy, axis, n, variant=variant)

    mat_specs = tuple(P(axis, None) for _ in mat_inputs)
    in_specs = mat_specs + ((row_spec, row_spec, row_spec) if M_local else (row_spec, row_spec))
    shard_fn = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=CGResult(x=row_spec, iterations=P(), residual=P(), converged=P()),
    )
    donate_argnums = (len(mat_inputs) + 1,) if donate else ()
    return jax.jit(shard_fn, donate_argnums=donate_argnums), mat_inputs


def sharded_cg_solve_general(
    A,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    dtype=None,
    variant: str = "cg",
) -> CGResult:
    """One-call convenience: place a CSR/ELL system on the mesh and solve with
    exact-halo-range communication."""
    if mesh is None:
        from conjugategradient_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(axis=axis)
    dt = dtype or np.asarray(A.data).dtype
    A = A.astype(dt) if np.asarray(A.data).dtype != dt else A
    solve, mat_inputs = make_sharded_cg_general(
        A, mesh, policy, axis=axis, M_local=M_local, variant=variant
    )
    row = NamedSharding(mesh, P(axis))
    b_dev = jax.device_put(jnp.asarray(np.asarray(b, dtype=dt)), row)
    x0_arr = np.zeros(A.n, dtype=dt) if x0 is None else np.asarray(x0, dtype=dt)
    x0_dev = jax.device_put(jnp.asarray(x0_arr), row)
    if M_local is not None:
        aux = jax.device_put(jnp.asarray(np.asarray(M_aux, dtype=dt)), row)
        return solve(*mat_inputs, b_dev, x0_dev, aux)
    return solve(*mat_inputs, b_dev, x0_dev)
