"""CGNR: CG on the normal equations ``A^T A x = A^T b``.

The third nonsymmetric option beside BiCGStab (can break down / stagnate)
and GMRES (memory grows with the restart): CGNR always works for any
nonsingular A, with constant memory and guaranteed monotone ``||A r||``
decrease — at the price of squaring the condition number, so it is the
fallback, not the default (BiCGStab first, GMRES second; see USERGUIDE).

Built entirely from existing pieces: ``core.formats.transpose`` (host
setup) + the shared ``cg_solve`` recurrence over the composed operator
``x -> A^T (A x)`` — two SpMVs per iteration, fused into the same jitted
``lax.while_loop`` as every other solver here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from conjugategradient_tpu.core.formats import transpose
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import CGResult, cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION


def cgnr_solve(
    A,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b (square, nonsingular, possibly nonsymmetric) by CGNR.

    The loop's convergence criterion applies to the NORMAL-equation
    residual ``||A^T (b - A x)||`` (that is CG's residual here); the
    returned ``residual`` is re-evaluated as the TRUE ``||b - A x||`` in
    the policy's norm, so callers compare against what they asked for.
    kappa(A^T A) = kappa(A)^2 — expect roughly the square of the
    equivalent CG iteration count.
    """
    from conjugategradient_tpu.ops.blas import residual_norm

    A_t = transpose(A)
    A_dev = A.device_put(dtype=b.dtype) if hasattr(A, "device_put") else A
    At_dev = A_t.device_put(dtype=b.dtype) if hasattr(A_t, "device_put") else A_t
    op = as_operator(A_dev)
    opT = as_operator(At_dev)
    r0 = b - op(jnp.zeros_like(b) if x0 is None else x0.astype(b.dtype))
    rr0 = jnp.vdot(r0, r0, precision=MATMUL_PRECISION, preferred_element_type=b.dtype)
    res = cg_solve(
        lambda x: opT(op(x)),
        opT(b),
        x0,
        policy,
        precise_dot=precise_dot,
    )
    r = b - op(res.x)
    rr = jnp.vdot(r, r, precision=MATMUL_PRECISION, preferred_element_type=r.dtype)
    true_res = residual_norm(r, rr, rr0, policy.norm)
    return dataclasses.replace(res, residual=true_res)
