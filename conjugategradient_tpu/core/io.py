"""Matrix ingestion: Matrix Market files and scipy.sparse interop.

The reference only ever solves its own synthetic generators (SURVEY.md §6);
a framework users switch TO also has to ingest the matrices they already
have.  Two standard routes:

- **Matrix Market** (``.mtx``, the NIST/SuiteSparse interchange format):
  ``load_matrix_market`` / ``save_matrix_market``.  Loading picks the
  device-appropriate storage automatically: matrices whose nonzeros sit on few
  distinct diagonals (relative to a storage-blowup budget) land in DIA —
  the format every fast path here keys on — everything else in CSR.
- **scipy.sparse**: ``from_scipy`` / ``to_scipy``.  ``to_scipy`` also makes
  every container directly usable with ``scipy.sparse.linalg`` for
  cross-validation (the same differential-testing stance as the drivers).

Host-side by design (file IO and format analysis are setup work); the
returned containers ``device_put`` like any other.
"""

from __future__ import annotations

import numpy as np

from conjugategradient_tpu.core.formats import (
    CooMatrix,
    CsrMatrix,
    DiaMatrix,
    coo_to_csr,
    csr_to_dia,
    _any_to_csr,
)


def from_scipy(m) -> CsrMatrix:
    """Any ``scipy.sparse`` matrix -> ``CsrMatrix`` (duplicates summed).

    CSR inputs take the direct path: reuse ``indptr``/``indices``/``data``
    as-is (canonicalizing on a copy only when scipy hasn't already) instead
    of round-tripping through COO + an O(nnz log nnz) lexsort — measured as
    THE dominant term of the blocked-AMG setup (2.0 of 3.4 s at 511^2,
    eighteen conversions per hierarchy)."""
    import scipy.sparse as sp

    from conjugategradient_tpu.core.formats import csr_from_parts

    if sp.issparse(m) and m.format == "csr":
        if not m.has_canonical_format:
            m = m.copy()
            m.sum_duplicates()
        # copy the buffers: the container must not alias the caller's scipy
        # matrix (in-place edits there would mutate it underneath us); the
        # O(nnz) memcpy is still ~10x cheaper than the COO lexsort this
        # fast path replaces
        return csr_from_parts(
            np.array(m.data), np.array(m.indices), np.array(m.indptr),
            tuple(m.shape),
        )
    coo = m.tocoo()
    return coo_to_csr(
        CooMatrix(
            data=np.asarray(coo.data),
            rows=np.asarray(coo.row, np.int32),
            cols=np.asarray(coo.col, np.int32),
            shape=tuple(coo.shape),
        )
    )


def to_scipy(A):
    """Any container -> ``scipy.sparse.csr_matrix``."""
    import scipy.sparse as sp

    csr = A if isinstance(A, CsrMatrix) else _any_to_csr(A)
    return sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=csr.shape,
    )


def load_matrix_market(path, prefer: str = "auto", max_blowup: float = 3.0):
    """Read a Matrix Market file into the right container.

    ``prefer``: ``"auto"`` (DIA when the diagonal-storage blowup
    ``n_diags * n / nnz`` stays under ``max_blowup``, else CSR — banded
    matrices hit the DIA/stencil fast paths, irregular ones the segment-sum
    CSR path), ``"csr"``, or ``"dia"`` (raises if the matrix truly is not
    expressible on its diagonal set — it always is; the guard is the
    blowup, which ``prefer="dia"`` ignores).

    Symmetric/skew/hermitian Matrix Market storage is expanded by scipy on
    read, so the returned operator is the full matrix.
    """
    from scipy.io import mmread

    m = mmread(str(path))
    csr = from_scipy(m)
    if prefer == "csr":
        return csr
    n, mcols = csr.shape
    if n != mcols:
        return csr  # DIA is square-only
    diags = np.unique(
        np.asarray(csr.indices, np.int64) - np.asarray(csr.row_ids, np.int64)
    )
    if prefer == "dia" or len(diags) * n <= max_blowup * max(csr.nnz, 1):
        return csr_to_dia(csr, offsets=tuple(int(o) for o in diags))
    return csr


def save_matrix_market(path, A, comment: str = "") -> None:
    """Write any container as a Matrix Market coordinate file."""
    from scipy.io import mmwrite

    mmwrite(str(path), to_scipy(A).tocoo(), comment=comment)


def load_vector_market(path) -> np.ndarray:
    """Read a Matrix Market dense array file as a flat (n,) vector."""
    from scipy.io import mmread

    v = np.asarray(mmread(str(path)))
    return v.reshape(-1)


def save_vector_market(path, v, comment: str = "") -> None:
    from scipy.io import mmwrite

    mmwrite(str(path), np.asarray(v).reshape(-1, 1), comment=comment)
