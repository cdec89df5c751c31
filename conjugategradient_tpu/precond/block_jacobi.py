"""Block-Jacobi preconditioner: batched dense diagonal-block inverses.

Fills the gap between point Jacobi (``smoothers.jacobi_preconditioner`` —
one multiply, weak) and multigrid (needs a grid): invert the ``bs x bs``
diagonal blocks of A once at setup, apply them as ONE batched matmul per
solve iteration.  No reference analogue (its only preconditioning trace is
the commented-out ViennaCL ``jacobi_precond``,
``Mgcg/ViennaCL/Mgcg/ComputerGpu.cpp:96-101``).

Device fit: the apply is ``einsum('bij,bj->bi', B_inv, r)`` — one
``(nb, bs, bs) @ (nb, bs)`` batched matmul at ``MATMUL_PRECISION``; for
multi-RHS it batches over columns too.  SPD A with SPD blocks gives an SPD
M (valid for CG); nonsymmetric A works with BiCGStab/GMRES (right
preconditioning).  Shard-equivariance: when ``block_size`` divides the
shard length, blocks never cross shard boundaries, so the SAME apply works
as an ``M_local`` inside ``shard_map`` solvers.

Setup is host-side numpy (one pass over the nonzeros + a batched
``np.linalg.inv`` — setup work, like the hierarchy builders); the inverse
block tensor then lives on device.
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.core.formats import CsrMatrix, _any_to_csr
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def block_jacobi_blocks(A, block_size: int) -> np.ndarray:
    """Extract the inverted diagonal blocks: ``(nb, bs, bs)`` fp64 numpy.

    Rows past ``n`` (when ``block_size`` does not divide n) are identity —
    the same identity-row padding convention as ``pad_system``.  Raises
    ``numpy.linalg.LinAlgError`` if a diagonal block is singular (cannot
    happen for strictly diagonally dominant or SPD A).
    """
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    csr = A if isinstance(A, CsrMatrix) else _any_to_csr(A)
    n = csr.shape[0]
    nb = -(-n // bs)
    rows = np.asarray(csr.row_ids, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    vals = np.asarray(csr.data, np.float64)
    keep = rows // bs == cols // bs
    r, c, v = rows[keep], cols[keep], vals[keep]
    B = np.zeros((nb, bs, bs))
    np.add.at(B, (r // bs, r % bs, c % bs), v)
    pad = nb * bs - n
    if pad:
        B[-1, bs - pad :, :] = 0.0
        B[-1, :, bs - pad :] = 0.0
        B[-1, np.arange(bs - pad, bs), np.arange(bs - pad, bs)] = 1.0
    return np.linalg.inv(B)


def block_jacobi_aux(A, block_size: int, dtype=None) -> np.ndarray:
    """Row-sharded carrier for the inverse blocks: ``(n_padded, bs)`` where
    row ``i`` holds ``Binv[i // bs, i % bs, :]``.

    This layout makes distributed block-Jacobi a SHARD-LOCAL operation:
    the array row-shards exactly like the solution vector (spec
    ``P(axis, None)``), and as long as ``block_size`` divides the shard
    length every block lives wholly on one shard — apply with
    ``block_jacobi_M_local``.
    """
    Binv = block_jacobi_blocks(A, block_size)
    nb, bs, _ = Binv.shape
    out = Binv.reshape(nb * bs, bs)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def block_jacobi_M_local(r_local, aux_local):
    """Shard-local apply for the ``block_jacobi_aux`` layout (``M_local``
    signature of the sharded solvers).  Requires the shard length to be a
    multiple of the block size."""
    n_local = r_local.shape[0]
    bs = aux_local.shape[1]
    B = aux_local.reshape(n_local // bs, bs, bs)
    R = r_local.reshape(n_local // bs, bs)
    return jnp.einsum(
        "bij,bj->bi", B, R, precision=MATMUL_PRECISION,
        preferred_element_type=r_local.dtype
    ).reshape(n_local)


def block_jacobi_preconditioner(
    A, block_size: int, dtype=None
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build ``M(r) = blockdiag(A)^-1 r`` for any matrix container.

    The returned callable is shape-agnostic over the trailing-RHS axis:
    ``(n,)`` vectors and ``(n, k)`` blocks both work (so it drops into
    ``cg_solve``, ``bicgstab_solve``/``gmres_solve``, ``cg_solve_multi``
    and ``lobpcg`` unchanged).
    """
    n = A.shape[0]
    bs = int(block_size)
    Binv_np = block_jacobi_blocks(A, bs)
    if dtype is None:
        dtype = np.asarray(A.data).dtype
    Binv = jnp.asarray(Binv_np, dtype=dtype)
    nb = Binv_np.shape[0]
    pad = nb * bs - n

    def M(r):
        shape = r.shape
        flat = r.reshape(n, -1)  # (n, k); k = 1 for vectors
        if pad:
            flat = jnp.pad(flat, ((0, pad), (0, 0)))
        out = jnp.einsum(
            "bij,bjk->bik", Binv, flat.reshape(nb, bs, -1),
            precision=MATMUL_PRECISION, preferred_element_type=flat.dtype,
        ).reshape(nb * bs, -1)
        return out[:n].reshape(shape)

    return M
