"""Precision policy and extended-precision reductions.

``MATMUL_PRECISION`` is the one precision every fp32 ``dot``/``einsum``/
``matmul`` in the package passes.  Left unset, XLA may run an fp32 matrix
product in TF32 (GPU tensor cores) or bf16 passes, which keep about three
decimal digits — too few for a coarse-grid solve, a Gram matrix or a
block-Jacobi apply inside a Krylov loop.  The products it governs are
small or bandwidth-bound, so full precision costs next to nothing.

The reference is fp64 end-to-end (CUDA ``double``, OpenCL ``-D REAL=double``).
Reaching its tolerances from fp32 storage needs compensated arithmetic on
the *reductions* (dots are where CG loses accuracy; the axpy updates are
benign).  Two tools, both fully vectorized (no sequential scans):

- ``dot2``     — error-free transformed dot: TwoProduct per element
  (captures every product rounding error exactly), then two tree sums.
  Error ~ tree-sum error (O(log n * eps)) instead of the naive
  O(sqrt(n) * eps) random walk.  ~3x the FLOPs of a plain dot, same memory
  traffic.
- ``kahan_sum`` — compensated tree sum for small-count exact sums.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

#: Precision of every fp32 matrix product in the package (see module doc).
MATMUL_PRECISION = lax.Precision.HIGHEST

#: ``_split`` per dtype: the unsigned view of the bits and how many low
#: stored significand bits to round away — float32 keeps 12 of its 24
#: significand bits, float64 26 of 53.
_SPLIT_BITS = {
    jnp.dtype(jnp.float32): (jnp.uint32, 12),
    jnp.dtype(jnp.float64): (jnp.uint64, 27),
}


def _split(a):
    """a = hi + lo exactly, with hi rounded to half the significand, so the
    product of any two halves is exact in a's dtype.

    The rounding works on the bit pattern (add half a unit, clear the low
    bits).  Dekker's ``hi = c - (c - a)`` with ``c = a * 4097`` is not used:
    XLA contracts ``a * 4097 - a`` into one FMA, which silently breaks that
    split; this one has no multiply to contract, and ``a - hi`` is exact."""
    try:
        utype, drop = _SPLIT_BITS[jnp.dtype(a.dtype)]
    except KeyError:
        raise TypeError(f"no exact split for dtype {a.dtype}") from None
    bits = lax.bitcast_convert_type(a, utype)
    bits = (bits + utype(1 << (drop - 1))) & ~utype((1 << drop) - 1)
    hi = lax.bitcast_convert_type(bits, a.dtype)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a*b = p + e exactly.

    Every multiply is of ``_split`` halves and exact; the two cross terms
    sum exactly (they share a binade), one TwoSum carries the rounding of
    ``hh + cross`` into e, and adding the last product to that error is
    exact again.  So an FMA that contracts any multiply into its add gives
    the same bits — the transform survives XLA's contraction, where
    Dekker's ``a * b - p`` does not."""
    ah, al = _split(a)
    bh, bl = _split(b)
    p, e = _two_sum(ah * bh, ah * bl + al * bh)
    return p, e + al * bl


def _two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth TwoSum)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def dd_sum(p: jnp.ndarray, e: jnp.ndarray | None = None):
    """Double-float (hi, lo) binary-tree sum — vectorized, log2(n) steps.

    Maintains a compensated (s, c) pair through a halving tree: every level is
    one vectorized TwoSum over the full remaining width, so the whole
    reduction is ~4n element ops with error O(n * eps^2) — fp64-grade
    accuracy from fp32 lanes, with no sequential scan.
    """
    s = p.reshape(-1)
    c = jnp.zeros_like(s) if e is None else e.reshape(-1)
    while s.shape[0] > 1:
        m = s.shape[0]
        if m % 2:
            s = jnp.pad(s, (0, 1))
            c = jnp.pad(c, (0, 1))
            m += 1
        s2 = s.reshape(m // 2, 2)
        c2 = c.reshape(m // 2, 2)
        t, err = _two_sum(s2[:, 0], s2[:, 1])
        s = t
        c = c2[:, 0] + c2[:, 1] + err
    return s[0] + c[0]


def dot2(a: jnp.ndarray, b: jnp.ndarray):
    """Compensated inner product for the solver hot path: error-free products,
    plain tree accumulation of (p, e).  One fused pass, ~3x a naive dot,
    error ~ tree-sum error — ample for recurrence dots (ultimate accuracy is
    the iterative-refinement outer loop's job, ``solvers/refine.py``)."""
    p, e = two_prod(a, b)
    return jnp.sum(p) + jnp.sum(e)


def dd_dot(a: jnp.ndarray, b: jnp.ndarray):
    """Near-fp64 inner product: error-free products + double-float tree
    accumulation (error O(n * eps^2)).  ~2x dot2's cost; use when the dot
    itself is the deliverable (norm reporting, validation)."""
    p, e = two_prod(a, b)
    return dd_sum(p, e)


def kahan_sum(x: jnp.ndarray):
    """Compensated sum — delegates to the ``dd_sum`` tree (every pairwise add
    is an error-free TwoSum, so large/small cancellation survives exactly;
    strictly more accurate than chunked Neumaier and fully parallel)."""
    return dd_sum(x)


def kahan_dot(a: jnp.ndarray, b: jnp.ndarray):
    """Compensated inner product — alias for ``dot2`` (the vectorized
    error-free-transform formulation; the name is kept for API continuity)."""
    return dot2(a, b)


def promote_dot(a: jnp.ndarray, b: jnp.ndarray, dtype=jnp.float32):
    """Dot with explicit accumulation dtype (e.g. bf16 storage, fp32 accum)."""
    return jnp.vdot(a.astype(dtype), b.astype(dtype), precision=MATMUL_PRECISION,
                    preferred_element_type=dtype)
