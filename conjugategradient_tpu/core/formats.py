"""Sparse-matrix storage formats, designed for device-resident solves.

The reference implements CSR (``Mgcg/cuBlas/Mgcg/SparseMatrix.cs:8-101``),
ELL with the diagonal stored first (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:8-385``),
a DOK builder (``Mgcg/ViennaCL/MgcgCL/CompressedMatrix.cs:8-69``) and dense
(``R/CG.R:4-24``).  We keep all of those *plus* DIA (diagonal) storage, which is
the natural device format: every reference workload is banded, and a banded SpMV
in DIA form is a sum of element-wise products with *statically shifted* windows
of ``x`` — streaming work with zero gathers, which is exactly what XLA fuses.

All device containers are registered JAX pytrees, so they pass transparently
through ``jit`` / ``shard_map`` / ``lax.while_loop`` carries.  Static structure
(shape, diagonal offsets, pad width) is pytree *metadata*, mirroring how the
reference specialises its OpenCL kernels with compile-time defines
(``-D REAL=double -D MAX_NONZERO_COUNT=n``,
``Mgcg/HandmadeCL/MgcgCL/ConjugateGradientSingleGpu.cs:160-166``): dtype and
row-width are baked into the compiled program, not runtime values.

Conversions are host-side numpy (optionally accelerated by the C++ kit in
``conjugategradient_tpu.native``); device math lives in
``conjugategradient_tpu.ops``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

Shape = Tuple[int, int]


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=list(data_fields), meta_fields=list(meta_fields))
    return cls


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (banded) storage.

    ``data[k, i] == A[i, i + offsets[k]]`` and is exactly zero whenever
    ``i + offsets[k]`` falls outside ``[0, n)``.  ``offsets`` is static
    metadata (a tuple of python ints), so the SpMV lowers to a fixed set of
    statically-shifted fused multiply-adds.

    The zero padding outside the matrix is load-bearing for the distributed
    path: ring-wrapped halo values from ``ppermute`` at the global edges are
    multiplied by these structural zeros (see ``parallel/sharded_cg.py``),
    the same trick the reference gets from its exact ``minJ/maxJ`` halo ranges
    (``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:82-84``).
    """

    data: jax.Array | np.ndarray  # (ndiags, n)
    offsets: Tuple[int, ...]
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def bandwidth(self) -> int:
        """Largest |offset| — the halo width the distributed solver needs."""
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def nnz(self) -> int:
        """Stored entries that can be structurally nonzero (diagonal lengths)."""
        n = self.n
        return int(sum(n - abs(o) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DiaMatrix":
        return DiaMatrix(self.data.astype(dtype), self.offsets, self.shape)

    def device_put(self, dtype=None) -> "DiaMatrix":
        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        import jax.numpy as jnp

        return DiaMatrix(jnp.asarray(data), self.offsets, self.shape)


_register(DiaMatrix, ["data"], ["offsets", "shape"])


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK storage: fixed width ``k`` per row, padded.

    Equivalent of the reference's ELL matrix with per-row ``NonzeroCounts``
    (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:23,71-88``).  Padding convention:
    ``cols`` of padding slots point at the row's own index and ``data`` is 0,
    so a gather-based SpMV needs no masking.  Exceeding ``k`` at build time
    raises, the static-shape version of the reference's overflow exception
    (``SparseMatrix.cs:138-141``).
    """

    data: jax.Array | np.ndarray  # (n, k)
    cols: jax.Array | np.ndarray  # (n, k) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return int(self.data.shape[1])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "EllMatrix":
        return EllMatrix(self.data.astype(dtype), self.cols, self.shape)

    def device_put(self, dtype=None) -> "EllMatrix":
        import jax.numpy as jnp

        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        return EllMatrix(jnp.asarray(data), jnp.asarray(np.asarray(self.cols, dtype=np.int32)), self.shape)


_register(EllMatrix, ["data", "cols"], ["shape"])


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Compressed sparse row, as in ``Mgcg/cuBlas/Mgcg/SparseMatrix.cs:13-23``.

    ``row_ids`` (the COO row index of every stored entry) is precomputed so the
    XLA SpMV is a single ``segment_sum`` over ``data * x[indices]`` — the
    data-parallel formulation of cusparseDcsrmv (``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:10-19``).
    """

    data: jax.Array | np.ndarray  # (nnz,)
    indices: jax.Array | np.ndarray  # (nnz,) int32 column indices
    indptr: jax.Array | np.ndarray  # (n+1,) int32
    row_ids: jax.Array | np.ndarray  # (nnz,) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(self.data.astype(dtype), self.indices, self.indptr, self.row_ids, self.shape)

    def device_put(self, dtype=None) -> "CsrMatrix":
        import jax.numpy as jnp

        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        as_i32 = lambda a: jnp.asarray(np.asarray(a, dtype=np.int32))
        return CsrMatrix(jnp.asarray(data), as_i32(self.indices), as_i32(self.indptr), as_i32(self.row_ids), self.shape)


_register(CsrMatrix, ["data", "indices", "indptr", "row_ids"], ["shape"])


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Coordinate triplets (build/interchange format)."""

    data: jax.Array | np.ndarray  # (nnz,)
    rows: jax.Array | np.ndarray  # (nnz,) int32
    cols: jax.Array | np.ndarray  # (nnz,) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype


_register(CooMatrix, ["data", "rows", "cols"], ["shape"])


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """Variable-coefficient stencil operator on a d-dimensional tensor grid.

    The *performance* format for structured grids (no reference analogue —
    this is where the layout-aware redesign pays): unknowns keep their
    natural grid shape, each stencil leg ``shifts[k]`` (a d-tuple, e.g.
    (0, 1) = east neighbour) stores a grid-shaped coefficient array, and
    SpMV is a fused sum of statically shifted element-wise products (see
    ``ops.stencil``).

    ``data[k][idx] = A[idx, idx + shifts[k]]`` in grid coordinates; legs
    store exact zeros where the neighbour exits the grid (same masking
    convention as ``DiaMatrix``).  Flat row-major vector order matches
    ``DiaMatrix`` with offset ``dot(shifts[k], strides)``.
    """

    data: jax.Array | np.ndarray  # (nlegs, *grid)
    shifts: Tuple[Tuple[int, ...], ...]  # static d-tuples
    grid: Tuple[int, ...]  # static grid shape

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def n(self) -> int:
        return int(np.prod(self.grid))

    @property
    def shape(self) -> Shape:
        return (self.n, self.n)

    @property
    def nlegs(self) -> int:
        return len(self.shifts)

    @property
    def nnz(self) -> int:
        n = self.n
        total = 0
        for s in self.shifts:
            inside = 1
            for g, d in zip(self.grid, s):
                inside *= max(g - abs(d), 0)
            total += inside
        return total

    @property
    def halo(self) -> Tuple[int, ...]:
        """Per-axis max |shift| — the halo width per grid axis."""
        return tuple(max(abs(s[ax]) for s in self.shifts) for ax in range(self.ndim))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "StencilMatrix":
        return StencilMatrix(self.data.astype(dtype), self.shifts, self.grid)

    def device_put(self, dtype=None) -> "StencilMatrix":
        import jax.numpy as jnp

        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        return StencilMatrix(jnp.asarray(data), self.shifts, self.grid)


_register(StencilMatrix, ["data"], ["shifts", "grid"])


@dataclasses.dataclass(frozen=True)
class ConstStencilMatrix:
    """Constant-coefficient stencil: one scalar per leg, NO grid-shaped data.

    The Dirichlet Laplacians (the whole Poisson ladder) have position-
    independent coefficients — diag 2d, neighbours -1 — with boundary
    behaviour expressed entirely by the zero-padded SpMV (a neighbour
    outside the grid contributes 0, exactly the matrix's missing entry).
    So the operator needs ZERO bytes of matrix stream: SpMV traffic drops
    from (nlegs + 2) * n to 2 * n words for the 5-point fine level, which
    dominates every V-cycle's smoothing cost.

    ``build_hierarchy`` detects const-representable levels automatically
    (``stencil_to_const``); all solver paths treat this interchangeably
    with ``StencilMatrix`` (same grid-native protocol).
    """

    coeffs: Tuple[float, ...]  # per-leg scalars — STATIC metadata: they bake
    # into the compiled program as literals (a traced (nlegs,) array measured
    # ~1.5x slower inside fused solver loops: dynamic scalar broadcasts block
    # XLA's constant folding of the shifted-add chain)
    shifts: Tuple[Tuple[int, ...], ...]  # static d-tuples
    grid: Tuple[int, ...]  # static grid shape

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def n(self) -> int:
        return int(np.prod(self.grid))

    @property
    def shape(self) -> Shape:
        return (self.n, self.n)

    @property
    def nlegs(self) -> int:
        return len(self.shifts)

    @property
    def nnz(self) -> int:
        total = 0
        for s in self.shifts:
            inside = 1
            for g, d in zip(self.grid, s):
                inside *= max(g - abs(d), 0)
            total += inside
        return total

    @property
    def halo(self) -> Tuple[int, ...]:
        return tuple(max(abs(s[ax]) for s in self.shifts) for ax in range(self.ndim))

    def astype(self, dtype) -> "ConstStencilMatrix":
        return self  # literals cast at trace time against the operand dtype

    def device_put(self, dtype=None) -> "ConstStencilMatrix":
        return self  # nothing to place: the operator has zero array data


_register(ConstStencilMatrix, [], ["coeffs", "shifts", "grid"])


def const_to_stencil(cst: "ConstStencilMatrix") -> "StencilMatrix":
    """Expand back to grid-shaped legs (zero where the neighbour exits) —
    for paths that need explicit leg arrays (e.g. shard_map resharding)."""
    coeffs = np.asarray(cst.coeffs)
    legs = np.broadcast_to(
        coeffs.reshape((cst.nlegs,) + (1,) * cst.ndim), (cst.nlegs,) + cst.grid
    ).copy()
    idx = np.indices(cst.grid)
    for k, sh in enumerate(cst.shifts):
        valid = np.ones(cst.grid, dtype=bool)
        for ax, d in enumerate(sh):
            coord = idx[ax] + d
            valid &= (coord >= 0) & (coord < cst.grid[ax])
        legs[k] = np.where(valid, legs[k], 0.0)
    return StencilMatrix(legs, cst.shifts, cst.grid)


def stencil_to_const(st: "StencilMatrix"):
    """StencilMatrix -> ConstStencilMatrix when exactly representable
    (each leg constant over its in-grid region, zero outside), else None.
    Host-side setup helper — call on concrete (non-traced) data."""
    data = np.asarray(st.data)
    nd = st.ndim
    coeffs = []
    for k, s in enumerate(st.shifts):
        # the valid region is a hyperrectangle: slice it directly (the old
        # np.indices mask materialised (nd, *grid) int arrays per call —
        # ~200 s of churn at 511^3; this is one contiguous scan per leg).
        # Clamp the stop at the start: a |shift| >= extent leg has an EMPTY
        # valid region, and an unclamped negative stop would wrap around
        # and fabricate a coefficient (review finding, differential-tested)
        ins = tuple(
            slice(max(0, -d), max(max(0, -d), st.grid[ax] - max(0, d)))
            for ax, d in enumerate(s)
        )
        leg = data[k]
        inside = leg[ins]
        if inside.size == 0:
            coeffs.append(0.0)
            continue
        c = inside.flat[0]
        if not np.all(inside == c):
            return None
        # outside = union of per-axis border slabs; check each
        for ax, d in enumerate(s):
            if d == 0:
                continue
            sl = [slice(None)] * nd
            sl[ax] = slice(st.grid[ax] - d, None) if d > 0 else slice(0, -d)
            if np.any(leg[tuple(sl)] != 0):
                return None
        coeffs.append(float(c))
    return ConstStencilMatrix(tuple(coeffs), st.shifts, st.grid)


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block CSR: dense (R, C) blocks in CSR layout over the block grid.

    The blocked sparse format (new vs the reference, required by the
    BASELINE north-star's "CSR/COO/BSR storage"): the per-block work is a
    dense (R, C) x (C,) product, so SpMV/SpMM become batched small matrix
    products.  ``block_row_ids`` is precomputed (like CSR's
    ``row_ids``) so the reduction is one ``segment_sum``.
    """

    data: jax.Array | np.ndarray  # (nblocks, R, C)
    indices: jax.Array | np.ndarray  # (nblocks,) int32 block-column ids
    indptr: jax.Array | np.ndarray  # (n_block_rows + 1,) int32
    block_row_ids: jax.Array | np.ndarray  # (nblocks,) int32
    shape: Shape  # element shape (n, m); must divide by block shape

    @property
    def block_shape(self) -> Shape:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        r, c = self.block_shape
        return self.nblocks * r * c  # stored entries (incl. explicit zeros)

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "BsrMatrix":
        return BsrMatrix(self.data.astype(dtype), self.indices, self.indptr, self.block_row_ids, self.shape)

    def device_put(self, dtype=None) -> "BsrMatrix":
        import jax.numpy as jnp

        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        as_i32 = lambda a: jnp.asarray(np.asarray(a, dtype=np.int32))
        return BsrMatrix(
            jnp.asarray(data), as_i32(self.indices), as_i32(self.indptr), as_i32(self.block_row_ids), self.shape
        )


_register(BsrMatrix, ["data", "indices", "indptr", "block_row_ids"], ["shape"])


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense SPD matrix (the R prototype path, ``R/CG.R:4-24``); SpMV is one matvec."""

    data: jax.Array | np.ndarray  # (n, n)

    @property
    def shape(self) -> Shape:
        return (int(self.data.shape[0]), int(self.data.shape[1]))

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DenseMatrix":
        return DenseMatrix(self.data.astype(dtype))

    def device_put(self, dtype=None) -> "DenseMatrix":
        import jax.numpy as jnp

        data = np.asarray(self.data)
        if dtype is not None:
            data = data.astype(dtype)
        return DenseMatrix(jnp.asarray(data))


_register(DenseMatrix, ["data"], [])


# ---------------------------------------------------------------------------
# Host-side (numpy) conversions.
# ---------------------------------------------------------------------------


def coo_to_csr(coo: CooMatrix, sum_duplicates: bool = True) -> CsrMatrix:
    """Sort COO triplets into CSR, summing duplicates (DOK-builder backend)."""
    n, m = coo.shape
    rows = np.asarray(coo.rows, dtype=np.int64)
    cols = np.asarray(coo.cols, dtype=np.int64)
    data = np.asarray(coo.data)
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    if sum_duplicates and len(rows) > 0:
        # Collapse runs of identical (row, col).
        keys = rows * m + cols
        first = np.concatenate(([True], keys[1:] != keys[:-1]))
        group = np.cumsum(first) - 1
        data = np.bincount(group, weights=data, minlength=int(group[-1]) + 1).astype(data.dtype)
        rows, cols = rows[first], cols[first]
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CsrMatrix(
        data=data,
        indices=cols.astype(np.int32),
        indptr=indptr,
        row_ids=rows.astype(np.int32),
        shape=(n, m),
    )


def csr_to_coo(csr: CsrMatrix) -> CooMatrix:
    """CSR -> COO triplets (the inverse of ``coo_to_csr``; ``row_ids``
    already carries the expanded row index per nonzero, so this is a
    relabelling, not a computation)."""
    return CooMatrix(
        data=np.asarray(csr.data),
        rows=np.asarray(csr.row_ids, dtype=np.int32),
        cols=np.asarray(csr.indices, dtype=np.int32),
        shape=csr.shape,
    )


def csr_from_parts(data, indices, indptr, shape: Shape) -> CsrMatrix:
    indptr = np.asarray(indptr, dtype=np.int32)
    n = shape[0]
    row_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    return CsrMatrix(np.asarray(data), np.asarray(indices, dtype=np.int32), indptr, row_ids, shape)


def csr_to_dense(csr: CsrMatrix) -> DenseMatrix:
    n, m = csr.shape
    out = np.zeros((n, m), dtype=np.asarray(csr.data).dtype)
    np.add.at(out, (np.asarray(csr.row_ids), np.asarray(csr.indices)), np.asarray(csr.data))
    return DenseMatrix(out)


def dense_to_csr(dense: DenseMatrix, tol: float = 0.0) -> CsrMatrix:
    a = np.asarray(dense.data)
    rows, cols = np.nonzero(np.abs(a) > tol)
    return coo_to_csr(CooMatrix(a[rows, cols], rows.astype(np.int32), cols.astype(np.int32), dense.shape))


def csr_to_ell(csr: CsrMatrix, k: int | None = None) -> EllMatrix:
    """CSR -> ELL with the diagonal entry stored first when present.

    Mirrors the reference's diag-first ELL layout
    (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:71-88``); raises if any row has
    more than ``k`` entries (its overflow rule, ``SparseMatrix.cs:138-141``).
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr)
    counts = np.diff(indptr)
    kmax = int(counts.max()) if n else 0
    if k is None:
        k = kmax
    if kmax > k:
        raise ValueError(f"row with {kmax} nonzeros exceeds ELL width k={k}")
    data = np.zeros((n, k), dtype=np.asarray(csr.data).dtype)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k)) % max(m, 1)
    cdat = np.asarray(csr.data)
    cidx = np.asarray(csr.indices)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        row_cols = cidx[lo:hi]
        row_vals = cdat[lo:hi]
        diag_pos = np.nonzero(row_cols == i)[0]
        order = list(diag_pos) + [j for j in range(hi - lo) if j not in set(diag_pos.tolist())]
        for slot, j in enumerate(order):
            data[i, slot] = row_vals[j]
            cols[i, slot] = row_cols[j]
    return EllMatrix(data, cols, (n, m))


def ell_to_csr(ell: EllMatrix) -> CsrMatrix:
    n, m = ell.shape
    data = np.asarray(ell.data)
    cols = np.asarray(ell.cols)
    mask = data != 0
    rows = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, ell.k))
    return coo_to_csr(CooMatrix(data[mask], rows[mask], cols[mask].astype(np.int32), (n, m)))


def csr_to_dia(csr: CsrMatrix, offsets: Tuple[int, ...] | None = None) -> DiaMatrix:
    """CSR -> DIA.  ``offsets`` defaults to every structurally present diagonal."""
    n, m = csr.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = np.asarray(csr.data)
    diag = cols - rows
    if offsets is None:
        offsets = tuple(int(o) for o in np.unique(diag))
    off_arr = np.asarray(offsets, dtype=np.int64)
    pos = np.searchsorted(off_arr, diag)
    ok = (pos < len(off_arr)) & (off_arr[np.minimum(pos, len(off_arr) - 1)] == diag)
    if not np.all(ok):
        raise ValueError("matrix has entries outside the requested diagonal set")
    data = np.zeros((len(offsets), n), dtype=vals.dtype)
    np.add.at(data, (pos, rows), vals)
    return DiaMatrix(data, tuple(offsets), (n, n))


def dia_to_dense(dia: DiaMatrix) -> DenseMatrix:
    n = dia.n
    out = np.zeros((n, n), dtype=np.asarray(dia.data).dtype)
    data = np.asarray(dia.data)
    for k, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        out[i, i + off] = data[k, i]
    return DenseMatrix(out)


def dia_to_csr(dia: DiaMatrix) -> CsrMatrix:
    n = dia.n
    data = np.asarray(dia.data)
    rows_l, cols_l, vals_l = [], [], []
    for k, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows_l.append(i)
        cols_l.append(i + off)
        vals_l.append(data[k, i])
    if rows_l:
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    else:
        rows = cols = np.zeros(0, dtype=np.int64)
        vals = np.zeros(0, dtype=data.dtype)
    return coo_to_csr(CooMatrix(vals, rows.astype(np.int32), cols.astype(np.int32), (n, n)))


def _grid_strides(grid: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major strides: flat = sum(idx[ax] * strides[ax])."""
    s = [1] * len(grid)
    for ax in range(len(grid) - 2, -1, -1):
        s[ax] = s[ax + 1] * grid[ax + 1]
    return tuple(s)


def _decompose_offset(off: int, grid: Tuple[int, ...]) -> Tuple[int, ...]:
    """Flat row-major offset -> canonical per-axis shift with |shift| < grid
    extent, each component nearest zero.

    Rounding alone fails on exotic shifts whose tail sits just past a
    half-stride boundary, so each component is clamped until the remainder
    is representable by the remaining axes (|rem| <= sum of their maximal
    spans); raises only when no in-extent decomposition exists.
    """
    strides = _grid_strides(grid)
    rem = off
    out = []
    for ax in range(len(grid)):
        st = strides[ax]
        max_rest = sum((grid[a] - 1) * strides[a] for a in range(ax + 1, len(grid)))
        # feasible components: |d| < extent AND the remainder representable
        # by the remaining axes (|rem - d*st| <= max_rest); the intersection
        # is an interval — take the element nearest rem/st (nearest zero tie)
        lo = max(-(grid[ax] - 1), -((max_rest - rem) // st))
        hi = min(grid[ax] - 1, (rem + max_rest) // st)
        if lo > hi:
            raise ValueError(f"offset {off} not decomposable on grid {grid}")
        d = int(np.clip(int(np.round(rem / st)), lo, hi))
        rem = rem - d * st
        out.append(d)
    if rem != 0:
        raise ValueError(f"offset {off} not decomposable on grid {grid}")
    return tuple(out)


def dia_to_stencil(
    dia: DiaMatrix, grid: Tuple[int, ...], copy: bool = True
) -> "StencilMatrix":
    """DIA -> grid stencil.  Exact: every flat offset must decompose into a
    per-axis shift, and entries whose *grid* neighbour differs from their
    *flat* neighbour (row-seam wraps) must already be zero in ``data`` —
    which our generators and Galerkin products guarantee; violations raise.

    ``copy=False`` returns the data as a zero-copy reshape VIEW of
    ``dia.data`` (row-major flat order == grid order) — the setup fast path
    for huge grids (a 3.7 GB memcpy at 511^3) — at the price of aliasing:
    mutating either object's buffer then silently changes the other.  Safe
    when both objects are transient setup state (``build_hierarchy``);
    the default copies.
    """
    n = int(np.prod(grid))
    if dia.n != n:
        raise ValueError(f"prod(grid)={n} != n={dia.n}")
    data = np.asarray(dia.data)
    nd = len(grid)
    shifts = []
    # the invalid set of a leg (grid neighbour out of range on SOME axis)
    # is a union of per-axis BORDER SLABS — validate those O(boundary)
    # regions directly instead of materialising (nd, n) coordinate arrays
    # and per-leg masks (measured: the old form was ~200 s of int64 churn
    # at 511^3 = 133M rows; this is milliseconds).  The data itself then
    # reshapes as a zero-copy view (row-major flat order == grid order).
    view = data.reshape((dia.ndiags,) + tuple(grid))
    if copy:
        view = view.copy()
    for k, off in enumerate(dia.offsets):
        shift = _decompose_offset(off, grid)
        shifts.append(shift)
        for ax, s_ in enumerate(shift):
            if s_ == 0:
                continue
            sl = [slice(None)] * nd
            # coord + s_ out of [0, g): the last s_ planes (s_>0) / first
            # |s_| planes (s_<0) along this axis
            sl[ax] = slice(grid[ax] - s_, None) if s_ > 0 else slice(0, -s_)
            strip = view[k][tuple(sl)]
            if np.any(strip != 0):
                raise ValueError(
                    f"offset {off}: {int(np.count_nonzero(strip))} nonzeros "
                    "wrap a grid seam; matrix is not a stencil on this grid"
                )
    return StencilMatrix(view, tuple(shifts), tuple(grid))


def stencil_to_dia(st: "StencilMatrix") -> DiaMatrix:
    strides = _grid_strides(st.grid)
    n = st.n
    data = np.asarray(st.data).reshape(st.nlegs, n)
    offsets = []
    for s in st.shifts:
        offsets.append(int(sum(d * t for d, t in zip(s, strides))))
    if len(set(offsets)) != len(offsets):
        raise ValueError(
            f"distinct grid shifts alias the same flat offset on grid {st.grid}; "
            "cannot represent as DIA"
        )
    order = np.argsort(offsets)
    out = np.zeros((st.nlegs, n), dtype=data.dtype)
    # zero entries whose flat neighbour exits [0, n) (grid masking is stricter,
    # so this is already guaranteed; keep DIA's own convention anyway)
    i = np.arange(n)
    for slot, k in enumerate(order):
        off = offsets[k]
        valid = (i + off >= 0) & (i + off < n)
        out[slot] = np.where(valid, data[k], 0.0)
    return DiaMatrix(out, tuple(offsets[k] for k in order), (n, n))


def csr_to_bsr(csr: CsrMatrix, block_shape: Tuple[int, int] = (8, 8)) -> BsrMatrix:
    """CSR -> block CSR.  Rows/cols must divide by the block shape (pad the
    system first otherwise); blocks with any nonzero are stored dense."""
    n, m = csr.shape
    R, C = block_shape
    if n % R or m % C:
        raise ValueError(f"shape {csr.shape} not divisible by block {block_shape}")
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = np.asarray(csr.data)
    brow, bcol = rows // R, cols // C
    keys = brow * (m // C) + bcol
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    uniq, start = np.unique(keys_s, return_index=True)
    nblocks = len(uniq)
    data = np.zeros((nblocks, R, C), dtype=vals.dtype)
    block_of = np.searchsorted(uniq, keys)
    data[block_of, rows % R, cols % C] = vals
    b_rows = (uniq // (m // C)).astype(np.int32)
    b_cols = (uniq % (m // C)).astype(np.int32)
    indptr = np.zeros(n // R + 1, dtype=np.int32)
    np.add.at(indptr, b_rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return BsrMatrix(data, b_cols, indptr, b_rows, (n, m))


def bsr_to_csr(bsr: BsrMatrix) -> CsrMatrix:
    R, C = bsr.block_shape
    n, m = bsr.shape
    data = np.asarray(bsr.data)
    brows = np.asarray(bsr.block_row_ids, dtype=np.int64)
    bcols = np.asarray(bsr.indices, dtype=np.int64)
    rr, cc = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    rows = (brows[:, None, None] * R + rr[None]).ravel()
    cols = (bcols[:, None, None] * C + cc[None]).ravel()
    vals = data.ravel()
    keep = vals != 0
    return coo_to_csr(
        CooMatrix(vals[keep], rows[keep].astype(np.int32), cols[keep].astype(np.int32), (n, m))
    )


def dia_diagonal(dia: DiaMatrix) -> np.ndarray:
    """The main diagonal (for Jacobi preconditioning / smoothers)."""
    if 0 not in dia.offsets:
        return np.zeros(dia.n, dtype=np.asarray(dia.data).dtype)
    return np.asarray(dia.data)[dia.offsets.index(0)].copy()


def matrix_diagonal(A) -> np.ndarray:
    """Main diagonal for any storage format (host numpy) — the shared helper
    behind Jacobi/Chebyshev preconditioner setup."""
    if isinstance(A, DiaMatrix):
        return dia_diagonal(A)
    csr = _any_to_csr(A)
    d = np.zeros(csr.n)
    rows = np.asarray(csr.row_ids)
    cols = np.asarray(csr.indices)
    on_diag = rows == cols
    d[rows[on_diag]] = np.asarray(csr.data)[on_diag]
    return d


def jacobi_scaled_dia(A: DiaMatrix):
    """Symmetric Jacobi scaling: ``(A', d_inv_sqrt)`` with
    ``A' = D^{-1/2} A D^{-1/2}`` in the same DIA layout (host-side setup).

    The preconditioning form that survives structure-rigid recurrences
    (s-step CA-CG's shift-matrix identity, Chebyshev's polynomial): solve
    ``A' y = d_inv_sqrt * b`` and recover ``x = d_inv_sqrt * y``.  A' has
    unit diagonal; column scaling pads with the row-indexed values shifted
    by each offset (structural zeros stay zero)."""
    d = dia_diagonal(A)
    if np.any(d <= 0):
        raise ValueError("symmetric Jacobi scaling needs a positive diagonal")
    dis = (1.0 / np.sqrt(d)).astype(np.asarray(A.data).dtype)
    n = A.n
    data = np.array(np.asarray(A.data), copy=True)
    for k, off in enumerate(A.offsets):
        col = np.zeros(n, dtype=dis.dtype)
        lo, hi = max(0, -off), min(n, n - off)
        col[lo:hi] = dis[lo + off : hi + off]
        data[k] = data[k] * dis * col
    return DiaMatrix(data, A.offsets, A.shape), dis


def transpose(A):
    """A^T in the same storage family (host-side, setup work).

    DIA transposes in place: offset ``o`` becomes ``-o`` and its column
    rolls by ``o`` positions (``A^T[i, i-o] = A[i-o, i]``); CSR/ELL/COO/BSR
    go through a COO row/column swap; Stencil round-trips through DIA
    (legs negate their shifts).  Enables normal-equations solvers (CGNR)
    and the ``is_symmetric`` diagnostic.
    """
    if isinstance(A, DiaMatrix):
        data = np.asarray(A.data)
        n = A.n
        out = np.zeros_like(data)
        order = np.argsort([-o for o in A.offsets])
        offsets_t = tuple(-A.offsets[k] for k in order)
        i = np.arange(n)
        for j, k in enumerate(order):
            off = A.offsets[k]
            # A^T[i, i-off] = A[i-off, i] = data[k][i-off]
            src = i - off
            ok = (src >= 0) & (src < n)
            out[j, ok] = data[k, src[ok]]
        return DiaMatrix(out, offsets_t, A.shape)
    if isinstance(A, DenseMatrix):
        return DenseMatrix(np.asarray(A.data).T.copy())
    if isinstance(A, StencilMatrix):
        dia = stencil_to_dia(A)
        return dia_to_stencil(transpose(dia), A.grid)
    if isinstance(A, ConstStencilMatrix):
        return stencil_to_const(transpose(const_to_stencil(A)))
    csr = _any_to_csr(A)
    coo_t = CooMatrix(
        data=np.asarray(csr.data),
        rows=np.asarray(csr.indices, np.int32),
        cols=np.asarray(csr.row_ids, np.int32),
        shape=(csr.shape[1], csr.shape[0]),
    )
    out = coo_to_csr(coo_t)
    if isinstance(A, EllMatrix):
        return csr_to_ell(out)
    return out


def is_symmetric(A, tol: float = 0.0) -> bool:
    """``max|A - A^T| <= tol`` (host-side diagnostic — e.g. guard a CG call
    on an ingested matrix before the recurrence silently breaks)."""
    csr = _any_to_csr(A)
    import scipy.sparse as sp

    m = sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=csr.shape,
    )
    d = m - m.T
    return float(np.abs(d.data).max()) <= tol if d.nnz else True


def to_bcoo(A):
    """Convert any container to a ``jax.experimental.sparse.BCOO`` — the
    ecosystem interchange point (users of jax's own sparse stack can hand
    matrices either way)."""
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp

    if isinstance(A, DenseMatrix):
        return jsparse.BCOO.fromdense(jnp.asarray(np.asarray(A.data)))
    csr = A if isinstance(A, CsrMatrix) else _any_to_csr(A)
    indices = np.stack(
        [np.asarray(csr.row_ids, dtype=np.int32), np.asarray(csr.indices, dtype=np.int32)],
        axis=1,
    )
    return jsparse.BCOO(
        (jnp.asarray(np.asarray(csr.data)), jnp.asarray(indices)), shape=csr.shape
    )


def from_bcoo(m) -> CsrMatrix:
    """``jax.experimental.sparse.BCOO`` -> CSR (host-side)."""
    indices = np.asarray(m.indices)
    data = np.asarray(m.data)
    return coo_to_csr(
        CooMatrix(
            data,
            indices[:, 0].astype(np.int32),
            indices[:, 1].astype(np.int32),
            (int(m.shape[0]), int(m.shape[1])),
        )
    )


def _any_to_csr(A) -> CsrMatrix:
    if isinstance(A, CsrMatrix):
        return A
    if isinstance(A, DiaMatrix):
        return dia_to_csr(A)
    if isinstance(A, StencilMatrix):
        return dia_to_csr(stencil_to_dia(A))
    if isinstance(A, ConstStencilMatrix):
        return dia_to_csr(stencil_to_dia(const_to_stencil(A)))
    if isinstance(A, EllMatrix):
        return ell_to_csr(A)
    if isinstance(A, CooMatrix):
        return coo_to_csr(A)
    if isinstance(A, BsrMatrix):
        return bsr_to_csr(A)
    if isinstance(A, DenseMatrix):
        return dense_to_csr(A)
    raise TypeError(f"cannot convert {type(A)} to CSR")
