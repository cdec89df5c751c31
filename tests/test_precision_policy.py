"""The precision policy and the error-free transforms.

- Every ``dot_general`` traced for MGCG, AMG-CG, block-Jacobi CG and the
  dense/BSR/ELL products carries ``MATMUL_PRECISION`` (an fp32 product left
  at the default may run in TF32 on a GPU, about three decimal digits).
- ``two_prod`` stays exact, and ``dd_dot`` double-float accurate, when XLA
  fuses them with their consumers and contracts multiplies into FMAs — the
  CPU backend does, and that broke Dekker's split.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core import generators
from conjugategradient_tpu.ops.precision import MATMUL_PRECISION, dd_dot, dot2, two_prod
from conjugategradient_tpu.solvers.cg import cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy

POL = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=50)


def _dot_precisions(closed_jaxpr):
    """``precision`` params of every dot_general, sub-jaxprs included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed_jaxpr.jaxpr)
    return found


def _mgcg():
    from conjugategradient_tpu.precond import as_preconditioner, build_hierarchy

    grid = (63, 63)
    sys_ = generators.poisson_system(grid, dtype=np.float32)
    h = build_hierarchy(sys_.A, grid, dtype=np.float32,
                        coarse_operator=generators.poisson_coarse_operator(np.float32))
    b = jnp.asarray(sys_.b, jnp.float32).reshape(grid)
    assert h.levels
    return (lambda h_, b_: cg_solve(h_.levels[0].A, b_, policy=POL,
                                    M=as_preconditioner(h_))), (h, b)


def _amg_cg():
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond.amg import amg_preconditioner, build_amg_hierarchy

    sys_ = generators.poisson_system((31, 31), dtype=np.float64)
    h = build_amg_hierarchy(from_scipy(to_scipy(sys_.A).tocsr()), dtype=np.float32)
    b = jnp.asarray(sys_.b, jnp.float32)
    return (lambda h_, b_: cg_solve(h_.levels[0].A, b_, policy=POL,
                                    M=amg_preconditioner(h_))), (h, b)


def _bjacobi_cg():
    from conjugategradient_tpu.precond.block_jacobi import block_jacobi_preconditioner

    sys_ = generators.banded_sin_system(256, 8, dtype=np.float32)
    M = block_jacobi_preconditioner(sys_.A, 16, dtype=np.float32)
    b = jnp.asarray(sys_.b, jnp.float32)
    return (lambda A_, b_: cg_solve(A_, b_, policy=POL, M=M)), (sys_.A.device_put(), b)


def _format_spmv(fmt, multi):
    from conjugategradient_tpu.core import formats
    from conjugategradient_tpu.ops.spmm import spmm
    from conjugategradient_tpu.ops.spmv import spmv

    A = generators.banded_sin_matrix(64, 6, dtype=np.float32)
    csr = formats.dia_to_csr(A)
    M = {"dense": lambda: formats.dia_to_dense(A),
         "bsr": lambda: formats.csr_to_bsr(csr, (8, 8)),
         "ell": lambda: formats.csr_to_ell(csr)}[fmt]()
    x = jnp.ones((64, 3) if multi else (64,), jnp.float32)
    return (spmm if multi else spmv), (M.device_put() if hasattr(M, "device_put") else M, x)


CASES = {
    "mgcg": _mgcg,
    "amg_cg": _amg_cg,
    "bjacobi_cg": _bjacobi_cg,
    "spmv_dense": lambda: _format_spmv("dense", False),
    "spmv_bsr": lambda: _format_spmv("bsr", False),
    "spmv_ell": lambda: _format_spmv("ell", False),
    "spmm_dense": lambda: _format_spmv("dense", True),
    "spmm_bsr": lambda: _format_spmv("bsr", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_dot_general_carries_the_policy(case):
    fn, args = CASES[case]()
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args))
    if case != "spmv_ell":  # ELL is a gather + row sum: no dot_general at all
        assert precisions, "expected at least one dot_general"
    want = (MATMUL_PRECISION, MATMUL_PRECISION)
    assert all(p == want for p in precisions), precisions


def _ill_conditioned(n, cond, seed=0):
    """fp32 vectors with dot condition ~cond (sum|ab| / |sum ab|) and the
    exact dot (fp32 products are exact in fp64; fsum is exact)."""
    rng = np.random.default_rng(seed)
    half = 0.5 * math.log2(cond)
    e = np.round(rng.uniform(0, half, n - 1))
    a = ((2 * rng.random(n - 1) - 1) * 2.0 ** e).astype(np.float32)
    b = ((2 * rng.random(n - 1) - 1) * 2.0 ** e).astype(np.float32)
    p = a.astype(np.float64) * b.astype(np.float64)
    tail = np.float32(math.fsum(np.abs(p)) / cond - math.fsum(p))
    a, b = np.append(a, np.float32(1.0)), np.append(b, tail)
    p = np.append(p, float(tail))
    return a, b, math.fsum(p), math.fsum(np.abs(p))


@pytest.mark.parametrize("cond", [1e4, 1e6, 1e8])
def test_dd_dot_fused_is_double_float_accurate(cond):
    """One jitted program: XLA fuses the products into the first tree level
    and may contract them into FMAs; the result must still be accurate to
    ~2^-48 x cond (plus the final rounding to fp32)."""
    a, b, exact, _ = _ill_conditioned(1 << 14, cond)
    got = float(jax.jit(dd_dot)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - exact) / abs(exact) <= 2.0 ** -23 + 16 * 2.0 ** -48 * cond


@pytest.mark.parametrize("cond", [1e4, 1e6, 1e8])
def test_dot2_within_tree_sum_bound(cond):
    """dot2 = exact products, plain tree sums: its error is the summation
    error alone, bounded by ~log2(n) eps sum|a b|."""
    n = 1 << 14
    a, b, exact, abs_sum = _ill_conditioned(n, cond, seed=1)
    got = float(jax.jit(dot2)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - exact) <= (math.log2(n) + 2) * 2.0 ** -24 * abs_sum


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fused", [False, True])
def test_two_prod_exact_over_wide_exponents(dtype, fused):
    """p + e == a * b exactly (checked in exact rational arithmetic), alone
    and fused with a consumer in one program."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    n = 4096
    a = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(dtype)
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(dtype)
    if fused:
        p, e = jax.jit(lambda u, v: tuple(t * 1.0 + 0.0 for t in two_prod(u, v)))(a, b)
    else:
        p, e = jax.jit(two_prod)(a, b)
    p, e = np.asarray(p), np.asarray(e)
    assert p.dtype == dtype and e.dtype == dtype
    bad = [i for i in range(0, n, 7)
           if Fraction(float(p[i])) + Fraction(float(e[i]))
           != Fraction(float(a[i])) * Fraction(float(b[i]))]
    assert not bad, bad[:5]


def test_two_prod_rejects_dtypes_without_a_split():
    with pytest.raises(TypeError, match="no exact split"):
        two_prod(jnp.ones(4, jnp.bfloat16), jnp.ones(4, jnp.bfloat16))
