"""Deflated / recycled CG: outlier eigenmodes removed once, reused per solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conjugategradient_tpu.core import generators, oracle
from conjugategradient_tpu.solvers.cg import cg_solve
from conjugategradient_tpu.solvers.deflation import (
    Deflation,
    deflated_cg_solve,
    lanczos_basis,
    make_deflation,
)
from conjugategradient_tpu.solvers.policy import ConvergencePolicy
from conjugategradient_tpu.ops.spmv import as_operator


POL = ConvergencePolicy(tol=1e-8, norm="rel_l2", max_iteration=100_000)


def _outlier_case(n=4096):
    sys_ = generators.outlier_system(n, band=16, n_outliers=4, scale=1e-3)
    return sys_, sys_.A.device_put(np.float64)


def test_lanczos_basis_is_orthonormal_and_tridiagonalises():
    sys_, A_dev = _outlier_case(1024)
    m = 24
    V, alphas, betas = jax.jit(
        lambda A_: lanczos_basis(lambda v: as_operator(A_)(v), 1024, m, jnp.float64)
    )(A_dev)
    V = np.asarray(V)
    assert np.abs(V @ V.T - np.eye(m)).max() < 1e-10
    # V A Vᵀ equals the tridiagonal assembled from the scalars
    AV = np.stack([oracle.spmv(sys_.A, V[j]) for j in range(m)])
    T = V @ AV.T
    a, b_ = np.asarray(alphas), np.asarray(betas)[:-1]
    T_ref = np.diag(a) + np.diag(b_, 1) + np.diag(b_, -1)
    assert np.abs(T - T_ref).max() < 1e-9


def test_deflation_cuts_iterations_on_outlier_spectrum():
    sys_, A_dev = _outlier_case()
    b = jnp.asarray(sys_.b)
    plain = cg_solve(A_dev, b, policy=POL, precise_dot=True)
    defl = make_deflation(sys_.A, k=8, m=48, dtype=np.float64)
    dres = deflated_cg_solve(A_dev, b, policy=POL, deflation=defl, precise_dot=True)
    assert bool(dres.converged)
    assert int(dres.iterations) <= int(plain.iterations) // 2
    # and the SOLUTION is right (not just the projected recurrence residual)
    r = sys_.b - oracle.spmv(sys_.A, np.asarray(dres.x, np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-7


def test_deflated_solution_matches_plain_cg():
    sys_, A_dev = _outlier_case(1024)
    b = jnp.asarray(sys_.b)
    plain = cg_solve(A_dev, b, policy=POL, precise_dot=True)
    defl = make_deflation(sys_.A, k=8, m=32, dtype=np.float64)
    dres = deflated_cg_solve(A_dev, b, policy=POL, deflation=defl, precise_dot=True)
    np.testing.assert_allclose(
        np.asarray(dres.x), np.asarray(plain.x), rtol=1e-5, atol=1e-8
    )


def test_deflation_is_a_pytree_jit_argument():
    sys_, A_dev = _outlier_case(1024)
    defl = make_deflation(sys_.A, k=4, m=24, dtype=np.float64)
    fn = jax.jit(
        lambda A_, d_, b_: deflated_cg_solve(
            A_, b_, policy=POL, deflation=d_, precise_dot=True
        )
    )
    res = fn(A_dev, defl, jnp.asarray(sys_.b))
    assert bool(res.converged)
    leaves = jax.tree_util.tree_leaves(defl)
    assert len(leaves) == 4  # W, AW, chol_E, scale — no static closures


def test_deflated_with_jacobi_preconditioner():
    from conjugategradient_tpu.core.formats import dia_diagonal
    from conjugategradient_tpu.precond import jacobi_preconditioner

    sys_, A_dev = _outlier_case(2048)
    b = jnp.asarray(sys_.b)
    inv_d = jnp.asarray(1.0 / dia_diagonal(sys_.A))
    M = jacobi_preconditioner(inv_d)
    plain = cg_solve(A_dev, b, policy=POL, M=M, precise_dot=True)
    defl = make_deflation(sys_.A, k=8, m=48, dtype=np.float64)
    dres = deflated_cg_solve(
        A_dev, b, policy=POL, deflation=defl, M=M, precise_dot=True
    )
    assert bool(dres.converged)
    assert int(dres.iterations) < int(plain.iterations)
    r = sys_.b - oracle.spmv(sys_.A, np.asarray(dres.x, np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-7


def test_recycling_amortises_over_a_solve_sequence():
    """The production pattern (SPH pressure projection): same matrix every
    time step, new RHS.  Probe once, deflate every solve; total matrix
    passes (probe SpMVs + deflated iterations) must beat plain CG's."""
    sys_, A_dev = _outlier_case(2048)
    m = 48
    defl = make_deflation(sys_.A, k=8, m=m, dtype=np.float64)
    rng = np.random.default_rng(7)
    total_plain = 0
    total_defl = m  # the probe's SpMVs count against deflation
    for step in range(5):
        b = jnp.asarray(rng.standard_normal(2048))
        total_plain += int(cg_solve(A_dev, b, policy=POL, precise_dot=True).iterations)
        dres = deflated_cg_solve(
            A_dev, b, policy=POL, deflation=defl, precise_dot=True
        )
        assert bool(dres.converged)
        total_defl += int(dres.iterations)
    assert total_defl < total_plain


def test_deflation_composes_with_refinement():
    """fp64-tolerance solve sequences on outlier spectra: deflated inner
    solves must reach the same absolute tolerance with fewer total device
    iterations than undeflated refinement."""
    from conjugategradient_tpu.solvers.refine import refined_solve

    sys_, _ = _outlier_case(2048)
    defl = make_deflation(sys_.A, k=8, m=48)  # fp32, like the inner solves
    base = refined_solve(sys_.A, sys_.b, tol=1e-10)
    dres = refined_solve(
        sys_.A, sys_.b, tol=1e-10, deflation=defl
    )
    for res in (base, dres):
        assert res.converged
        r = sys_.b - oracle.spmv(sys_.A, res.x)
        assert np.linalg.norm(r) < 1e-10
    assert dres.inner_iterations < base.inner_iterations


@pytest.mark.parametrize("device_residual", [False, True])
def test_deflation_composes_with_cm_kernel_refinement(device_residual):
    """Deflated inner solves on the gridless (flat DIA) refinement path,
    host- and device-resident outer loops."""
    from conjugategradient_tpu.solvers.refine import refined_solve

    sys_, _ = _outlier_case(1024)
    defl = make_deflation(sys_.A, k=8, m=48)
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-9, deflation=defl,
        device_residual=device_residual,
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-9


def test_sharded_deflated_cg_matches_single_device():
    """Distributed def-CG: the basis row-shards over the mesh, the (k,)
    Galerkin contraction psums, the k x k coarse solve replicates.  Same
    iteration count as single-device def-CG, oracle-validated solution,
    and the plain sharded solve must need strictly more iterations."""
    from conjugategradient_tpu.parallel.mesh import make_mesh
    from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve

    n = 4096
    sys_, A_dev = _outlier_case(n)
    defl = make_deflation(sys_.A, k=8, m=48)
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=2000)
    mesh = make_mesh(axis="x")
    res = sharded_cg_solve(
        sys_.A, sys_.b, policy=pol, mesh=mesh, dtype=np.float32, deflation=defl
    )
    assert bool(res.converged)
    rt = sys_.b - oracle.spmv(sys_.A, np.asarray(res.x, np.float64))
    assert np.linalg.norm(rt) / np.linalg.norm(sys_.b) < 1e-5

    single = deflated_cg_solve(
        sys_.A.device_put(np.float32), jnp.asarray(sys_.b, jnp.float32),
        policy=pol, deflation=defl, precise_dot=True,
    )
    assert abs(int(res.iterations) - int(single.iterations)) <= 2
    plain = sharded_cg_solve(sys_.A, sys_.b, policy=pol, mesh=mesh, dtype=np.float32)
    assert int(res.iterations) < int(plain.iterations)


def test_sharded_deflation_rejects_comm_reduced_variants():
    from conjugategradient_tpu.parallel.mesh import make_mesh
    from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve

    sys_, _ = _outlier_case(1024)
    defl = make_deflation(sys_.A, k=4, m=24)
    with pytest.raises(ValueError, match="variant"):
        sharded_cg_solve(
            sys_.A, sys_.b, mesh=make_mesh(axis="x"), dtype=np.float32,
            deflation=defl, variant="cg1",
        )


def test_make_deflation_rejects_indefinite():
    from conjugategradient_tpu.core.formats import DiaMatrix

    n = 256
    data = np.zeros((1, n))
    data[0] = np.linspace(-1.0, 1.0, n)  # indefinite diagonal
    A = DiaMatrix(data, (0,), (n, n))
    with pytest.raises(ValueError):
        make_deflation(A, k=4, m=16, dtype=np.float64)
