"""Device BLAS-1: dot / axpy / scal / norms.

The reference implements these four times (cuBLAS C ABI exports
``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:22-54``; handmade OpenCL kernels with multi-pass
tree reductions ``Mgcg/HandmadeCL/MgcgCL/Mgcg.cl:15-159``; managed extension
methods ``Mgcg/cuBlas/Mgcg/LongVector.cs:15-72``; ViennaCL/uBLAS delegation).
Here they are single jnp expressions: XLA fuses the element-wise work into
neighbouring ops and lowers reductions to tree reductions — the reference's
~10-kernel-launch, 3-blocking-read iteration (SURVEY.md §3.2) collapses into
one fused program.

All three of the reference's residual-norm conventions are provided
(SURVEY.md §2.4 "Residual norm" row).
"""

from __future__ import annotations

import jax.numpy as jnp

from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def dot(a: jnp.ndarray, b: jnp.ndarray, precise: bool = False):
    """Inner product.  With ``precise=True`` uses compensated summation
    (``ops.precision.kahan_dot``) — the mixed-precision answer to the
    reference's all-fp64 arithmetic from fp32 state."""
    if precise:
        from conjugategradient_tpu.ops.precision import kahan_dot

        return kahan_dot(a, b)
    # vdot reduces over *all* axes, so grid-shaped solver state (the stencil
    # fast path) and flat vectors share one code path
    return jnp.vdot(a, b, precision=MATMUL_PRECISION, preferred_element_type=a.dtype)


def axpy(alpha, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """y + alpha * x (the reference's ``SetAdded`` / cublasDaxpy)."""
    return y + alpha * x


def scal(alpha, x: jnp.ndarray) -> jnp.ndarray:
    return alpha * x


def max_abs(a: jnp.ndarray):
    """‖a‖∞ (the reference's ``MaxAbsolute`` / ReductionMaxAbsolute kernel)."""
    return jnp.max(jnp.abs(a))


def norm_l2(a: jnp.ndarray, precise: bool = False):
    return jnp.sqrt(dot(a, a, precise=precise))


def residual_norm(r: jnp.ndarray, rr, rr0, norm: str):
    """Residual in the selected convention.

    ``rr`` = r.r (already computed by the CG recurrence, so ``l2``/``rel_l2``
    are free); ``linf`` costs one extra reduction, as in the HandmadeCL
    variant (``ConjugateGradientSingleGpu.cs:410-442``).
    """
    if norm == "l2":
        return jnp.sqrt(rr)
    if norm == "linf":
        return max_abs(r)
    if norm == "rel_l2":
        return jnp.sqrt(rr / rr0)
    raise ValueError(f"unknown norm {norm!r}")
