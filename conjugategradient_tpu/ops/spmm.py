"""Sparse x dense: BSR SpMV and SpMM (multi-vector products) for every format.

SpMM raises arithmetic intensity: with a (n, k) block of right-hand sides,
DIA SpMM reads each coefficient once for k products, and BSR SpMM batches
dense (R, C) x (C, k) block products.  Neither exists in the
reference (single-RHS throughout); required by the BASELINE north-star's
"SpMV/SpMM".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core.formats import (
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
)
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def spmv_bsr(A: BsrMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Block-CSR SpMV: per-block dense products + one segment sum.

    Gathers C-wide slices of x per stored block, contracts with the dense
    blocks in a single batched einsum, then segment-sums over block rows.
    """
    R, C = A.block_shape
    xb = x.reshape(-1, C)  # (m//C, C)
    gathered = xb[A.indices]  # (nblocks, C)
    prods = jnp.einsum("brc,bc->br", A.data, gathered,
                       precision=MATMUL_PRECISION, preferred_element_type=x.dtype)
    yb = jax.ops.segment_sum(
        prods, A.block_row_ids, num_segments=A.shape[0] // R, indices_are_sorted=True
    )
    return yb.reshape(-1)


def spmm_dia(A: DiaMatrix, B: jnp.ndarray) -> jnp.ndarray:
    """(n, k) = A @ B via statically shifted row-blocks of B."""
    n = A.n
    W = A.bandwidth
    Bp = jnp.pad(B, ((W, W), (0, 0)))
    Y = jnp.zeros((n, B.shape[1]), dtype=jnp.result_type(A.data.dtype, B.dtype))
    for i, off in enumerate(A.offsets):
        Y = Y + A.data[i][:, None] * jax.lax.dynamic_slice(Bp, (W + off, 0), (n, B.shape[1]))
    return Y


def spmm_csr(A: CsrMatrix, B: jnp.ndarray) -> jnp.ndarray:
    prods = A.data[:, None] * B[A.indices]
    return jax.ops.segment_sum(prods, A.row_ids, num_segments=A.n, indices_are_sorted=True)


def spmm_ell(A: EllMatrix, B: jnp.ndarray) -> jnp.ndarray:
    return (A.data[..., None] * B[A.cols]).sum(axis=1)


def spmm_coo(A: CooMatrix, B: jnp.ndarray) -> jnp.ndarray:
    prods = A.data[:, None] * B[A.cols]
    return jax.ops.segment_sum(prods, A.rows, num_segments=A.n)


def spmm_bsr(A: BsrMatrix, B: jnp.ndarray) -> jnp.ndarray:
    """Batched (R, C) x (C, k) block products."""
    R, C = A.block_shape
    k = B.shape[1]
    Bb = B.reshape(-1, C, k)  # (m//C, C, k)
    gathered = Bb[A.indices]  # (nblocks, C, k)
    prods = jnp.einsum("brc,bck->brk", A.data, gathered,
                       precision=MATMUL_PRECISION, preferred_element_type=B.dtype)
    Yb = jax.ops.segment_sum(
        prods, A.block_row_ids, num_segments=A.shape[0] // R, indices_are_sorted=True
    )
    return Yb.reshape(A.shape[0], k)


def spmm_dense(A: DenseMatrix, B: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(A.data, B, precision=MATMUL_PRECISION,
                   preferred_element_type=B.dtype)


def spmm(A, B: jnp.ndarray) -> jnp.ndarray:
    """Dispatch A @ B for a (n, k) dense block of right-hand sides."""
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k), got shape {B.shape}")
    if isinstance(A, DiaMatrix):
        return spmm_dia(A, B)
    if isinstance(A, CsrMatrix):
        return spmm_csr(A, B)
    if isinstance(A, EllMatrix):
        return spmm_ell(A, B)
    if isinstance(A, CooMatrix):
        return spmm_coo(A, B)
    if isinstance(A, BsrMatrix):
        return spmm_bsr(A, B)
    if isinstance(A, DenseMatrix):
        return spmm_dense(A, B)
    raise TypeError(f"unsupported matrix type {type(A)}")
