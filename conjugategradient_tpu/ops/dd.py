"""Double-float (two-fp32) arithmetic: fp64-grade residuals on the device.

The reference evaluates its convergence contract in native fp64
(``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:201-270`` runs the whole recurrence in
``double``).  The host-side answer is refinement (``solvers/refine.py``):
the true residual ``r = b - A x`` is recomputed in numpy fp64 every outer
pass.  Correct — but the host SpMV is seconds per pass at 16.6M rows, and
the full-vector device-to-host copy it needs is paid every pass.

This module keeps that fp64-grade evaluation on device: every quantity is
an unevaluated sum ``hi + lo`` of two fp32 arrays (a "double-float", the
software analogue of double-double), and every operation propagates the
rounding error of the hi part into lo via error-free transforms — the same
Dekker/Knuth primitives ``ops.precision`` already uses for compensated
dots, extended from reductions to the full residual dataflow:

- products:  ``two_prod(a, xh)`` captures the fp32 product error exactly
  (the split is contraction-proof; see ``ops.precision._split``);
- sums:      ``two_sum`` / renormalisation keep the pair canonical
  (|lo| <= ulp(hi)/2);
- SpMV:      per-diagonal / per-leg dd accumulation over the SAME statically
  shifted windows as the fp32 fast paths (``ops.spmv.spmv_dia``,
  ``ops.stencil.spmv_stencil``) — XLA fuses it into one streaming loop,
  just with ~6x the flops, and the op stays bandwidth-bound.

Effective precision: eps_dd ~ 2^-48 (~3.6e-15 relative) — two decades below
any tolerance in the reference suite (absolute 1e-8 .. 1e-10), vs fp32's
~6e-8 which cannot certify them at all.

The matrix itself is carried as a hi/lo *pair of containers* (``DDMatrix``):
``hi = fp32(A)``, ``lo = fp32(A - hi)``, so the operator, not just the
vectors, is exact to dd precision.  Consumed by
``solvers.refine.refined_solve(device_residual=True)``, whose outer pass
(residual, norm, scaling, inner solve, solution update) becomes ONE jitted
device program with scalar-only readbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
)
from conjugategradient_tpu.ops.precision import _two_sum, two_prod
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION

# --------------------------------------------------------------------------
# pair primitives (all elementwise, fully vectorized)
# --------------------------------------------------------------------------


def _quick_two_sum(a, b):
    """a + b = s + e exactly, REQUIRES |a| >= |b| (renormalisation step)."""
    s = a + b
    return s, b - (s - a)


def dd_add(x, y):
    """(hi, lo) + (hi, lo) -> canonical (hi, lo).  Standard double-double
    add: TwoSum of the his, fold both los into the error, renormalise."""
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _quick_two_sum(s, e)


def dd_sub(x, y):
    return dd_add(x, (-y[0], -y[1]))


def dd_fma_f32(acc, a, x):
    """acc + a * x for fp32 ``a`` and dd ``x`` -> dd.

    The product splits exactly into ``two_prod(a, x.hi)``; the a*lo term is
    already O(eps) so a plain fp32 multiply suffices (error O(eps^2))."""
    p, e = two_prod(a, x[0])
    e = e + a * x[1]
    return dd_add(acc, (p, e))


def dd_fma_dd_coeff(acc, a, x):
    """acc + a * x with a dd COEFFICIENT ``a = (ah, al)`` and dd ``x``."""
    p, e = two_prod(a[0], x[0])
    e = e + a[0] * x[1] + a[1] * x[0]
    return dd_add(acc, (p, e))


def dd_axpy(x, s, d):
    """x + s * d for dd ``x``, fp32 scalar ``s``, fp32 array ``d`` -> dd.
    The update of iterative refinement: the product is captured exactly
    (two_prod), then folded in with a full dd add."""
    p, e = two_prod(jnp.asarray(s, d.dtype), d)
    return dd_add(x, (p, e))


def dd_zeros(shape, dtype=jnp.float32):
    z = jnp.zeros(shape, dtype)
    return z, z


def dd_value(x):
    """Collapse (hi, lo) to a best-effort single float (fp32: lossy)."""
    return x[0] + x[1]


# --------------------------------------------------------------------------
# host <-> device conversion
# --------------------------------------------------------------------------


def dd_from_f64(a: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split host fp64 into a device (hi, lo) fp32 pair (exact to ~2^-48)."""
    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def dd_to_f64(x) -> np.ndarray:
    """Reassemble the fp64 value of a (hi, lo) pair on the host."""
    return np.asarray(x[0], dtype=np.float64) + np.asarray(x[1], dtype=np.float64)


def _split_scalar(c: float) -> Tuple[float, float]:
    hi = float(np.float32(c))
    return hi, float(np.float64(c) - np.float64(hi))


# --------------------------------------------------------------------------
# dd matrix container
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DDMatrix:
    """An operator carried to dd precision: ``hi`` holds fp32(A), ``lo`` the
    fp32 remainder — both in the SAME storage format (DiaMatrix /
    StencilMatrix; ConstStencilMatrix keeps the split in static coeff
    metadata, so ``lo`` is None)."""

    hi: object
    lo: object  # same container type, or None for const stencils

    @property
    def n(self) -> int:
        return self.hi.n


jax.tree_util.register_dataclass(DDMatrix, data_fields=["hi", "lo"], meta_fields=[])


def dd_split_matrix(A) -> DDMatrix:
    """Split a HOST fp64 matrix container into a device-resident DDMatrix."""
    if isinstance(A, DiaMatrix):
        hi, lo = dd_from_f64(np.asarray(A.data))
        return DDMatrix(
            DiaMatrix(hi, A.offsets, A.shape), DiaMatrix(lo, A.offsets, A.shape)
        )
    if isinstance(A, StencilMatrix):
        hi, lo = dd_from_f64(np.asarray(A.data))
        return DDMatrix(
            StencilMatrix(hi, A.shifts, A.grid), StencilMatrix(lo, A.shifts, A.grid)
        )
    if isinstance(A, ConstStencilMatrix):
        his, los = zip(*(_split_scalar(c) for c in A.coeffs)) if A.coeffs else ((), ())
        return DDMatrix(
            ConstStencilMatrix(tuple(his), A.shifts, A.grid),
            ConstStencilMatrix(tuple(los), A.shifts, A.grid),
        )
    raise TypeError(f"dd_split_matrix: unsupported container {type(A)}")


# --------------------------------------------------------------------------
# dd SpMV — same shifted-window formulations as the fp32 fast paths
# --------------------------------------------------------------------------


def _dd_spmv_dia(ddm: DDMatrix, x):
    A_hi, A_lo = ddm.hi, ddm.lo
    n, B = A_hi.n, A_hi.bandwidth
    xh = jnp.pad(x[0], (B, B))
    xl = jnp.pad(x[1], (B, B))
    acc = dd_zeros((n,), x[0].dtype)
    for k, off in enumerate(A_hi.offsets):
        wh = jax.lax.dynamic_slice(xh, (B + off,), (n,))
        wl = jax.lax.dynamic_slice(xl, (B + off,), (n,))
        acc = dd_fma_dd_coeff(acc, (A_hi.data[k], A_lo.data[k]), (wh, wl))
    return acc


def _dd_spmv_stencil(ddm: DDMatrix, x):
    A_hi, A_lo = ddm.hi, ddm.lo
    halo = A_hi.halo
    pad = [(h, h) for h in halo]
    xh = jnp.pad(x[0], pad)
    xl = jnp.pad(x[1], pad)
    acc = dd_zeros(A_hi.grid, x[0].dtype)
    for k, shift in enumerate(A_hi.shifts):
        sl = tuple(
            slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A_hi.grid)
        )
        acc = dd_fma_dd_coeff(
            acc, (A_hi.data[k], A_lo.data[k]), (xh[sl], xl[sl])
        )
    return acc


def _dd_spmv_const_stencil(ddm: DDMatrix, x):
    A_hi, A_lo = ddm.hi, ddm.lo
    halo = A_hi.halo
    pad = [(h, h) for h in halo]
    xh = jnp.pad(x[0], pad)
    xl = jnp.pad(x[1], pad)
    acc = dd_zeros(A_hi.grid, x[0].dtype)
    for k, shift in enumerate(A_hi.shifts):
        sl = tuple(
            slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A_hi.grid)
        )
        ch = jnp.asarray(A_hi.coeffs[k], x[0].dtype)
        cl = jnp.asarray(A_lo.coeffs[k], x[0].dtype)
        acc = dd_fma_dd_coeff(acc, (ch, cl), (xh[sl], xl[sl]))
    return acc


def dd_spmv(ddm: DDMatrix, x):
    """y = A x in dd: dd vector in, dd vector out (grid-shaped for stencil
    containers, flat for DIA — matching the fp32 protocol)."""
    if isinstance(ddm.hi, ConstStencilMatrix):
        return _dd_spmv_const_stencil(ddm, x)
    if isinstance(ddm.hi, StencilMatrix):
        return _dd_spmv_stencil(ddm, x)
    if isinstance(ddm.hi, DiaMatrix):
        return _dd_spmv_dia(ddm, x)
    raise TypeError(f"dd_spmv: unsupported container {type(ddm.hi)}")


def dd_residual(ddm: DDMatrix, b, x):
    """r = b - A x, every term dd: the device twin of the refinement loop's
    host-fp64 ``b64 - oracle.spmv(A, x)``."""
    return dd_sub(b, dd_spmv(ddm, x))


# --------------------------------------------------------------------------
# dd norms (for convergence decisions: scalar accuracy ~eps32 RELATIVE to a
# dd-accurate value — ample for tolerance comparisons)
# --------------------------------------------------------------------------


def dd_norm_sq(r):
    """||r||^2 with the lo part folded in to first order (the hi*hi dot uses
    the error-free-transform ``dot2``, so cancellation in r survives)."""
    from conjugategradient_tpu.ops.precision import dot2

    rh = r[0].reshape(-1)
    rl = r[1].reshape(-1)
    return dot2(rh, rh) + 2.0 * jnp.vdot(rh, rl, precision=MATMUL_PRECISION)


def dd_max_abs(r):
    return jnp.max(jnp.abs(r[0] + r[1]))
