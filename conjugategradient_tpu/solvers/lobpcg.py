"""LOBPCG: block preconditioned eigensolver for the smallest eigenpairs.

Completes the eigen-analysis story (reference: the dense Jacobi-rotation
solver embedded in the ELL matrix, ``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs
:234-372``, and the R prototype's commented spectrum probes, ``R/CG.R:26-27``)
with the method actually used at scale: locally optimal block preconditioned
conjugate gradient (Knyazev, SIAM J. Sci. Comput. 23, 2001).  Finds the k
smallest eigenpairs of a sparse SPD operator from SpMM passes only — and
accepts the framework's own preconditioners (a multigrid V-cycle through
``solvers.multi.as_multi_preconditioner`` makes it a multigrid eigensolver).

Why it fits the device unusually well: every inner product in the method is
a ``(3k, n) @ (n, 3k)`` Gram matmul and every basis update a ``(n, 3k) @
(3k, k)`` matmul, while the only non-matmul pieces (two 3k x 3k
symmetric eigendecompositions) are tiny.  The whole iteration is one jitted
``lax.while_loop``; eigenvalues never leave the device.

Static-shape design notes (the places a textbook LOBPCG fights XLA):

- The search block ``S = [X, W, P]`` is ALWAYS ``(n, 3k)``: instead of the
  first iteration using a rank-2k basis (P = 0, a dynamic shape), P is
  INITIALISED as a random block — iteration one is then a 3k-subspace
  Rayleigh-Ritz whose extra directions are merely unhelpful, and the
  recurrence takes over from iteration two.
- Rank deficiency (W columns vanish as residuals converge; P aligns with
  X) cannot shrink the basis at trace time.  Orthonormalisation is
  SPECTRAL instead: ``G = S^T S = E diag(w) E^T``, keep directions with
  ``w > delta * max(w)``, whiten by ``1/sqrt(w)``, and hard-ZERO the
  dropped directions.  A Cholesky-QR with a diagonal shift is cheaper but
  WRONG here: it leaves near-dependent columns with tiny norms whose
  Rayleigh quotients fall below lambda_min and get selected as spurious
  "smallest" eigenpairs (observed: fake 4e-6 eigenvalues under the true
  5.9e-4 minimum on the 1-D Laplacian).
- Dropped directions would Rayleigh-Ritz to theta = 0 — the bottom of the
  spectrum, selected again.  They are parked at the TOP instead: their
  rows/columns of the projected operator are zeroed and their diagonal set
  above ``trace(H)`` (an upper bound for every true Ritz value of a PSD
  projection), so the bottom-k selection can never touch them.
- No soft locking: converged columns simply ride along (their Ritz values
  are stationary).  Convergence is one predicate on the worst column.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from conjugategradient_tpu.solvers.multi import _as_multi_operator


@dataclasses.dataclass(frozen=True)
class LobpcgResult:
    """Eigensolve outcome (a pytree; leaves stay on device)."""

    eigenvalues: jax.Array  # (k,) ascending
    eigenvectors: jax.Array  # (n, k) — columns, orthonormal
    iterations: jax.Array  # int32
    residuals: jax.Array  # (k,) relative residual norms ||A x - lam x|| / (|lam| + 1)
    converged: jax.Array  # bool


jax.tree_util.register_dataclass(
    LobpcgResult,
    data_fields=["eigenvalues", "eigenvectors", "iterations", "residuals", "converged"],
    meta_fields=[],
)


# every Gram/projection/update matmul runs at MATMUL_PRECISION: a
# reduced-precision fp32 matmul (TF32 or bf16 passes) corrupts the whitening
# eigendecomposition — max(res) stalls near 1e-1 with ~20% eigenvalue error,
# where full precision converges in a few iterations
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def _dotc(a, b):
    return jnp.matmul(a, b, precision=MATMUL_PRECISION)


def _colsq(S):
    return jnp.einsum("nj,nj->j", S, S, precision=MATMUL_PRECISION)


def _spectral_orth(S, delta, BS=None):
    """Whitened basis Q with near-null directions hard-zeroed.

    Columns are normalised FIRST (a vanished residual/P column must read as
    "dependent direction", not "small eigenvalue of G" — otherwise it
    survives any relative threshold and its 1/sqrt(w) whitening amplifies
    pure cancellation noise into a garbage basis vector; observed as
    late-stage corruption of converged eigenpairs).  Then ``G = S^T S =
    E diag(w) E^T``; directions with ``w <= delta * max(w)`` are dropped
    (zero columns).  Returns ``(Q, BQ, good)`` with Q exactly orthonormal
    on the kept directions.

    ``BS`` switches to the B-INNER-PRODUCT form for the generalized
    problem: ``G = S^T (B S)``, Q is B-orthonormal, and ``BQ = (B S)``
    whitened by the same combination — so the caller gets B Q without a
    second B pass.
    """
    BS_ = S if BS is None else BS
    norms = jnp.sqrt(jnp.einsum("nj,nj->j", S, BS_, precision=MATMUL_PRECISION))
    scale = jnp.where(norms > 0, norms, 1.0)[None, :]
    S = S / scale
    BS_ = BS_ / scale
    G = _dotc(S.T, BS_)
    G = 0.5 * (G + G.T)
    w, E = jnp.linalg.eigh(G)
    good = w > delta * jnp.max(w)
    inv_sqrt = jnp.where(good, 1.0 / jnp.sqrt(jnp.where(good, w, 1.0)), 0.0)
    Q = _dotc(S, E * inv_sqrt[None, :])
    BQ = Q if BS is None else _dotc(BS_, E * inv_sqrt[None, :])
    return Q, BQ, good


def lobpcg(
    A,
    k: int,
    X0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    tol: float = 1e-6,
    max_iterations: int = 200,
    seed: int = 0,
    dtype=jnp.float32,
    largest: bool = False,
    B=None,
) -> LobpcgResult:
    """k extreme eigenpairs of sparse SPD ``A`` (smallest by default).

    ``A``: any matrix container (DIA / stencil / CSR / ELL / ...) or a
    ``(n, j) -> (n, j)`` block operator callable.  ``M``: optional
    preconditioner on an ``(n, k)`` residual block — approximate A^-1, e.g.
    ``solvers.multi.as_multi_preconditioner(hierarchy)`` for multigrid or
    ``lambda R: inv_diag[:, None] * R`` for Jacobi.  ``largest=True`` flips
    the Ritz selection to the top of the spectrum.

    ``B`` (SPD, same container/operator forms as A) switches to the
    GENERALIZED problem ``A x = lambda B x`` (FEM mass matrices, weighted
    graphs): the basis is kept B-orthonormal (the spectral-orth whitening
    runs in the B inner product and hands back ``B Q`` for free, so the
    iteration costs ONE A pass + ONE B pass, both width 3k), Rayleigh-Ritz
    is the standard projected ``Q^T A Q`` (B-orthonormality makes the
    projected B the identity), and the residual is ``A X - (B X) diag(lam)``.

    Traceable end to end; returns a ``LobpcgResult``.
    """
    if callable(A) and not hasattr(A, "shape"):
        op, n = A, None
        if X0 is None:
            raise ValueError("X0 is required when A is passed as an operator")
    else:
        op = _as_multi_operator(A.device_put(dtype=dtype) if hasattr(A, "device_put") else A)
        n = A.shape[0]
    if B is None:
        opB = None
    elif callable(B) and not hasattr(B, "shape"):
        opB = B
    else:
        opB = _as_multi_operator(
            B.device_put(dtype=dtype) if hasattr(B, "device_put") else B
        )
    if X0 is None:
        key = jax.random.PRNGKey(seed)
        X0 = jax.random.normal(key, (n, k), dtype)
    else:
        X0 = jnp.asarray(X0, dtype)
        n, k = X0.shape
    # Gram eigenvalues of unit columns below ~eps^2-ish are cancellation
    # noise, not directions; sqrt(eps)-scaled thresholds keep whitening
    # amplification bounded by ~eps^-1/2
    delta = jnp.asarray(5e-7 if dtype == jnp.float32 else 1e-12, dtype)
    tol = jnp.asarray(tol, dtype)
    sign = -1.0 if largest else 1.0

    X, BX, _ = _spectral_orth(X0, delta, BS=None if opB is None else opB(X0))
    P0 = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, k), dtype)

    def body(state):
        X, AX, BX, P, lam, res, it = state
        R = AX - BX * lam[None, :]
        W = R if M is None else M(R)
        S = jnp.concatenate([X, W, P], axis=1)
        Q, BQ, good = _spectral_orth(
            S, delta, BS=None if opB is None else opB(S)
        )
        AQ = op(Q)  # the ONE A pass of the iteration (width 3k)
        H = _dotc(Q.T, AQ)
        H = 0.5 * (H + H.T)
        # park dropped directions above every true Ritz value
        big = jnp.trace(jnp.abs(H)) + 1.0
        mask2d = good[:, None] & good[None, :]
        Hs = jnp.where(mask2d, sign * H, 0.0)
        Hs = Hs + jnp.diag(jnp.where(good, 0.0, big))
        _theta, C = jnp.linalg.eigh(Hs)
        C1 = C[:, :k]  # ascending; sign flip selects the wanted end
        X_new = _dotc(Q, C1)
        AXn = _dotc(AQ, C1)  # A(Q C1) without a second matrix pass
        BXn = X_new if opB is None else _dotc(BQ, C1)  # likewise for B
        # P = the component of the update outside span(X) (projector form —
        # correct even though the whitened basis mixes the X/W/P blocks;
        # B-inner projector when generalized: X is B-orthonormal)
        P_new = X_new - _dotc(X, _dotc(BX.T, X_new))
        lam_new = jnp.einsum("nk,nk->k", X_new, AXn, precision=MATMUL_PRECISION)
        Rn = AXn - BXn * lam_new[None, :]
        res = jnp.sqrt(_colsq(Rn)) / (jnp.abs(lam_new) + 1.0)
        return X_new, AXn, BXn, P_new, lam_new, res, it + 1

    def cond(state):
        _X, _AX, _BX, _P, _lam, res, it = state
        return jnp.logical_and(jnp.max(res) >= tol, it < jnp.int32(max_iterations))

    AX0 = op(X)
    lam0 = jnp.einsum("nk,nk->k", X, AX0, precision=MATMUL_PRECISION)
    R0 = AX0 - BX * lam0[None, :]
    res0 = jnp.sqrt(_colsq(R0)) / (jnp.abs(lam0) + 1.0)
    X, _AX, _BX, P, lam, res, it = jax.lax.while_loop(
        cond, body, (X, AX0, BX, P0, lam0, res0, jnp.int32(0))
    )
    order = jnp.argsort(lam)
    return LobpcgResult(
        eigenvalues=lam[order],
        eigenvectors=X[:, order],
        iterations=it,
        residuals=res[order],
        converged=jnp.max(res) < tol,
    )


def gspmd_lobpcg(
    A,
    k: int,
    mesh,
    axis: str = "x",
    M: Optional[Callable] = None,
    dtype=jnp.float32,
    seed: int = 0,
    B=None,
    **kw,
) -> LobpcgResult:
    """Mesh-distributed LOBPCG via GSPMD sharding annotations.

    The method is matmuls all the way down (module docstring), which is
    exactly the shape GSPMD partitions well: the DIA matrix data and the
    (n, 3k) basis are placed row-sharded over ``axis``, and XLA derives the
    collectives — halo exchanges for the banded SpMM, one all-reduce per
    Gram product — while the 3k x 3k eigendecompositions replicate.  The
    same trajectory as the single-device solver up to reduction rounding
    (tested); ``M`` (if given) must be built from sharded operands by the
    caller.  Supports ``DiaMatrix``; other formats: shard by hand.
    """
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from conjugategradient_tpu.core.formats import DiaMatrix

    if not isinstance(A, DiaMatrix):
        raise TypeError("gspmd_lobpcg requires a DiaMatrix")
    n = A.shape[0]
    data = jax.device_put(
        jnp.asarray(np.asarray(A.data), dtype=dtype),
        NamedSharding(mesh, P(None, axis)),
    )
    A_sharded = DiaMatrix(data, A.offsets, A.shape)
    X0 = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(seed), (n, k), dtype),
        NamedSharding(mesh, P(axis, None)),
    )
    from conjugategradient_tpu.solvers.multi import _as_multi_operator

    op = _as_multi_operator(A_sharded)
    opB = None
    if B is not None:
        if not isinstance(B, DiaMatrix):
            raise TypeError("gspmd_lobpcg requires a DiaMatrix B")
        dataB = jax.device_put(
            jnp.asarray(np.asarray(B.data), dtype=dtype),
            NamedSharding(mesh, P(None, axis)),
        )
        opB = _as_multi_operator(DiaMatrix(dataB, B.offsets, B.shape))
    return lobpcg(op, k, X0=X0, M=M, dtype=dtype, seed=seed, B=opB, **kw)
