"""Sparse matrix-vector products — XLA paths for every storage format.

These are the library-delegated equivalents of cusparseDcsrmv
(``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:10-19``) and viennacl::prod
(``Mgcg/ViennaCL/Mgcg/ComputerGpu.cpp:49-73``): correct on any backend, and
XLA's fusion does the heavy lifting: no hand-written kernel stands in for
the reference's handmade OpenCL SpMV
(``Mgcg/HandmadeCL/MgcgCL/Mgcg.cl:171-216``).

Format-to-strategy map:

- DIA  — a sum of *statically shifted* element-wise products: no gathers at
  all, one fused stream over the diagonal data.  The natural form for every
  banded reference workload.  Speed of light = memory bandwidth over the
  diagonal data.
- ELL  — one gather of ``x`` per slot then a row reduction; XLA lowers the
  gather well when k is small and uniform (the whole point of ELL).
- CSR  — ``segment_sum`` over ``data * x[indices]`` with precomputed row ids
  (COO-style), a data-parallel formulation of row-pointer iteration.
- Dense — one matvec at ``MATMUL_PRECISION``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core.formats import (
    BsrMatrix,
    StencilMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
)
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def spmv_dia(A: DiaMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y[i] = sum_k data[k, i] * x[i + offsets[k]].

    Offsets are static metadata, so every shifted window is a *static* slice
    of a zero-padded ``x`` — XLA fuses the whole thing into one streaming
    loop over ``data`` (the dominant HBM traffic)."""
    n = A.n
    B = A.bandwidth
    xpad = jnp.pad(x, (B, B))
    y = jnp.zeros(n, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        y = y + A.data[k] * jax.lax.dynamic_slice(xpad, (B + off,), (n,))
    return y


def spmv_dia_roll(A: DiaMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """DIA SpMV with the shift expressed as a *cyclic roll*.

    Numerically identical to ``spmv_dia`` (the wraparound lands on DIA's
    structural zeros), but under GSPMD a roll partitions into a neighbor
    collective-permute of the boundary slice — the formulation the
    mesh-partitioned solvers (``parallel.gspmd``) use so XLA derives the halo
    exchange automatically.
    """
    y = jnp.zeros(A.n, dtype=jnp.result_type(A.data.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        y = y + A.data[k] * jnp.roll(x, -off)
    return y


def spmv_ell(A: EllMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Gather-based ELL SpMV; padding slots carry data==0 so no masking."""
    return (A.data * x[A.cols]).sum(axis=1)


def spmv_csr(A: CsrMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Segment-sum CSR SpMV (sorted row ids -> fast segment_sum lowering)."""
    prods = A.data * x[A.indices]
    return jax.ops.segment_sum(prods, A.row_ids, num_segments=A.n, indices_are_sorted=True)


def spmv_coo(A: CooMatrix, x: jnp.ndarray) -> jnp.ndarray:
    prods = A.data * x[A.cols]
    return jax.ops.segment_sum(prods, A.rows, num_segments=A.n)


def spmv_dense(A: DenseMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Dense matvec (the R-prototype path, at scale)."""
    return jnp.dot(A.data, x, precision=MATMUL_PRECISION,
                   preferred_element_type=x.dtype)


def spmv(A, x: jnp.ndarray) -> jnp.ndarray:
    from conjugategradient_tpu.core.formats import ConstStencilMatrix

    if isinstance(A, StencilMatrix):
        from conjugategradient_tpu.ops.stencil import spmv_stencil

        return spmv_stencil(A, x)
    if isinstance(A, ConstStencilMatrix):
        from conjugategradient_tpu.ops.stencil import spmv_const_stencil

        return spmv_const_stencil(A, x)
    if isinstance(A, DiaMatrix):
        return spmv_dia(A, x)
    if isinstance(A, EllMatrix):
        return spmv_ell(A, x)
    if isinstance(A, CsrMatrix):
        return spmv_csr(A, x)
    if isinstance(A, CooMatrix):
        return spmv_coo(A, x)
    if isinstance(A, BsrMatrix):
        from conjugategradient_tpu.ops.spmm import spmv_bsr

        return spmv_bsr(A, x)
    if isinstance(A, DenseMatrix):
        return spmv_dense(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def as_operator(A, roll: bool = False) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Wrap a matrix container (or pass through a callable) as ``x -> A@x``.

    ``roll=True`` selects the GSPMD-friendly cyclic-roll formulation for
    DIA and stencil matrices; other formats ignore it.
    """
    from conjugategradient_tpu.core.formats import ConstStencilMatrix

    if callable(A) and not isinstance(
        A,
        (DiaMatrix, EllMatrix, CsrMatrix, CooMatrix, BsrMatrix, DenseMatrix,
         StencilMatrix, ConstStencilMatrix),
    ):
        return A
    if roll and isinstance(A, StencilMatrix):
        from conjugategradient_tpu.ops.stencil import spmv_stencil_roll

        return partial(spmv_stencil_roll, A)
    if roll and isinstance(A, ConstStencilMatrix):
        from conjugategradient_tpu.ops.stencil import spmv_const_stencil_roll

        return partial(spmv_const_stencil_roll, A)
    if roll and isinstance(A, DiaMatrix):
        return partial(spmv_dia_roll, A)
    return partial(spmv, A)
