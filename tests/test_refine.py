"""Mixed-precision iterative refinement: fp64 tolerances from fp32 devices."""

import numpy as np
import pytest

from conjugategradient_tpu.core import oracle
from conjugategradient_tpu.core.generators import (
    banded_sin_system,
    poisson_system,
    tridiagonal_system,
)
from conjugategradient_tpu.solvers.policy import NotConvergedError
from conjugategradient_tpu.solvers.refine import refined_solve


def test_refinement_reaches_fp64_tolerance_with_fp32_inner():
    grid = (63, 63)
    sys_ = poisson_system(grid)
    res = refined_solve(sys_.A, sys_.b, tol=1e-10, grid=grid, device_dtype=np.float32)
    assert res.converged
    # the claim: true fp64 residual below what fp32 storage alone can reach
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-10
    assert res.outer_iterations <= 10
    assert all(b <= a * 1.01 for a, b in zip(res.history, res.history[1:]))


def test_refinement_flagship_absolute_tolerance():
    # the reference's flagship contract: absolute 1e-8 on ||r||_2 — met with
    # fp32 device arithmetic despite ||b|| ~ O(10) and x ~ O(1e-2..1)
    sys_ = banded_sin_system(4096, 32)
    res = refined_solve(sys_.A, sys_.b, sys_.x0, tol=1e-8, norm="l2", device_dtype=np.float32)
    assert res.converged
    ref = oracle.cg(sys_.A, sys_.b, sys_.x0, tol=1e-8)
    np.testing.assert_allclose(res.x, ref.x, rtol=1e-6, atol=1e-9)


def test_refinement_plain_cg_inner_no_grid():
    sys_ = tridiagonal_system(1023)
    res = refined_solve(sys_.A, sys_.b, tol=1e-8, device_dtype=np.float32, inner_tol=1e-4)
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-8


def test_refinement_divergence_flag():
    sys_ = tridiagonal_system(255)
    with pytest.raises(NotConvergedError):
        refined_solve(
            sys_.A, sys_.b, tol=1e-300, max_outer=2, raise_on_divergence=True, grid=(255,)
        )
    res = refined_solve(sys_.A, sys_.b, tol=1e-300, max_outer=2, grid=(255,))
    assert not res.converged and res.outer_iterations == 2


def test_slow_but_converging_refinement_completes():
    """A loose inner tolerance (0.5) makes every pass slow; the stall
    heuristic must not abandon it — stalling now requires TWO consecutive
    no-progress passes (VERDICT round 1, weak #5)."""
    grid = (31, 31)
    sys_ = poisson_system(grid)
    # plain-CG inner (no multigrid) so inner_tol=0.5 really does mean slow
    # ~2x-per-pass outer progress rather than an overshooting V-cycle
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-9, inner_tol=0.5, device_dtype=np.float32
    )
    assert res.converged and not res.stalled
    assert res.outer_iterations > 3  # genuinely many slow passes, not one lucky solve
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-9


def test_refined_solve_bf16_matrix_stream():
    """bf16-stored device matrix (half-width stream, fp32 accumulation):
    refinement still reaches the fp64 tolerance — the inner CG converges on
    the bf16-rounded operator and the fp64 outer passes correct for it."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core.generators import banded_sin_system

    sys_ = banded_sin_system(4096, 32, dtype=np.float64)
    res = refined_solve(
        sys_.A, sys_.b, sys_.x0, tol=1e-8, norm="l2",
        matrix_dtype=jnp.bfloat16,
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-8


# --- multi-RHS refinement -------------------------------------------------

from conjugategradient_tpu.solvers.refine import refined_solve_multi


def _block_rhs(n, k, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k))


def test_refined_multi_reaches_fp64_tolerance_mgcg():
    grid = (63, 63)
    sys_ = poisson_system(grid)
    B = _block_rhs(sys_.A.n, 4)
    res = refined_solve_multi(sys_.A, B, tol=1e-10, grid=grid)
    assert res.converged.all() and not res.stalled.any()
    for j in range(4):
        r = B[:, j] - oracle.spmv(sys_.A, res.x[:, j])
        assert np.linalg.norm(r) < 1e-10
    assert (res.inner_iterations > 0).all()


def test_refined_multi_matches_single_rhs_columns():
    sys_ = tridiagonal_system(511)
    B = _block_rhs(sys_.A.n, 3)
    res = refined_solve_multi(sys_.A, B, tol=1e-9, inner_tol=1e-4)
    assert res.converged.all()
    for j in range(3):
        single = refined_solve(sys_.A, B[:, j], tol=1e-9, inner_tol=1e-4)
        np.testing.assert_allclose(res.x[:, j], single.x, rtol=1e-7, atol=1e-10)


def test_refined_multi_freezes_converged_columns():
    # column 0's RHS is A @ e (solved in one pass); column 1 is random.
    # the easy column must stop accumulating inner iterations while the
    # hard column keeps refining.
    sys_ = tridiagonal_system(255)
    e = np.zeros(sys_.A.n)
    e[7] = 1.0
    B = np.stack([oracle.spmv(sys_.A, e), _block_rhs(sys_.A.n, 1)[:, 0]], axis=1)
    res = refined_solve_multi(sys_.A, B, tol=1e-10, inner_tol=1e-2, max_outer=30)
    assert res.converged.all()
    assert res.inner_iterations[0] <= res.inner_iterations[1]
    np.testing.assert_allclose(res.x[:, 0], e, atol=1e-9)


def test_refined_multi_facade_route():
    from conjugategradient_tpu.api import solve

    grid = (31, 31)
    sys_ = poisson_system(grid)
    B = _block_rhs(sys_.A.n, 2)
    res = solve(sys_.A, B, method="refined", tol=1e-9, grid=grid)
    assert hasattr(res, "stalled") and res.converged.all()
    for j in range(2):
        r = B[:, j] - oracle.spmv(sys_.A, res.x[:, j])
        assert np.linalg.norm(r) < 1e-9


# --- device-resident refinement (dd outer loop) ----------------------------


def test_device_residual_grid_matches_host_refinement():
    grid = (63, 63)
    sys_ = poisson_system(grid)
    dev = refined_solve(sys_.A, sys_.b, tol=1e-10, grid=grid, device_residual=True)
    host = refined_solve(sys_.A, sys_.b, tol=1e-10, grid=grid)
    assert dev.converged and host.converged
    r = sys_.b - oracle.spmv(sys_.A, dev.x)
    assert np.linalg.norm(r) < 1e-10
    np.testing.assert_allclose(dev.x, host.x, rtol=1e-8, atol=1e-12)


def test_device_residual_dia_flagship_contract():
    # the reference's absolute-1e-8 flagship contract, outer loop on device
    sys_ = banded_sin_system(4096, 16)
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-8, device_residual=True
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-8


def test_device_residual_redisc_const_hierarchy():
    # the big-3D fp64-contract configuration: device-resident dd outer loop
    # over a REDISCRETIZED const-stencil hierarchy, pinned here at toy scale
    from conjugategradient_tpu.core.generators import poisson_coarse_operator
    from conjugategradient_tpu.precond import build_hierarchy

    g = (31, 31, 31)
    sys_ = poisson_system(g)
    h = build_hierarchy(
        sys_.A, g, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
        coarse_operator=poisson_coarse_operator(np.float32),
    )
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-10, norm="rel_l2", grid=g, hierarchy=h,
        device_residual=True,
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-10


def test_device_residual_reaches_dd_floor_rel():
    # rel_l2 1e-12 is far below fp32 but above the dd floor (~4e-15)
    grid = (31, 31)
    sys_ = poisson_system(grid)
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-12, norm="rel_l2", grid=grid, device_residual=True
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-12


def test_device_residual_x0_and_linf():
    sys_ = banded_sin_system(1024, 8)
    res = refined_solve(
        sys_.A, sys_.b, x0=sys_.x0, tol=1e-7, norm="linf",
        device_residual=True,
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.abs(r).max() < 1e-7


def test_device_residual_unreachable_tol_terminates():
    # below the dd floor: must stall, exhaust max_outer, or hit an EXACTLY
    # zero dd residual (legal on tiny systems) — never loop or falsely claim
    sys_ = tridiagonal_system(255)
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-300, device_residual=True,
        max_outer=8,
    )
    assert res.outer_iterations <= 8
    if res.converged:
        assert res.residual == 0.0  # identically zero at dd precision
    else:
        assert res.stalled or res.outer_iterations == 8


def test_device_residual_rejects_fp64_state():
    sys_ = tridiagonal_system(63)
    with pytest.raises(ValueError):
        refined_solve(
            sys_.A, sys_.b, device_residual=True, device_dtype=np.float64
        )


def test_refined_multi_max_outer_flags_nonconvergence():
    sys_ = tridiagonal_system(127)
    B = _block_rhs(sys_.A.n, 2)
    res = refined_solve_multi(sys_.A, B, tol=1e-300, max_outer=2)
    assert not res.converged.any() and res.outer_iterations == 2


def test_gspmd_refined_solve_matches_single_device():
    """Mesh-partitioned refinement: dd outer pass + GSPMD MGCG inner solves
    over the 8-device mesh reach the same fp64 tolerance in the same outer/
    inner counts as the single-device device_residual path."""
    from conjugategradient_tpu.core.generators import poisson_system
    from conjugategradient_tpu.parallel.gspmd import gspmd_refined_solve
    from conjugategradient_tpu.parallel.mesh import make_mesh

    grid = (128, 128)  # 128 % 8 == 0: the fine level genuinely shards
    sys_ = poisson_system(grid)
    res = gspmd_refined_solve(sys_.A, sys_.b, grid, mesh=make_mesh(), tol=1e-10)
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-10

    single = refined_solve(sys_.A, sys_.b, tol=1e-10, grid=grid,
                           device_residual=True)
    assert res.outer_iterations == single.outer_iterations
    assert abs(res.inner_iterations - single.inner_iterations) <= 2


def test_gspmd_refined_solve_2d_mesh_variable_coefficients():
    """2-D block partition + variable-coefficient (StencilMatrix) dd path."""
    import jax
    from jax.sharding import Mesh

    from conjugategradient_tpu.core.generators import diffusion_system
    from conjugategradient_tpu.parallel.gspmd import gspmd_refined_solve

    grid = (64, 64)
    sys_ = diffusion_system(grid, kind="jump")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    res = gspmd_refined_solve(
        sys_.A, sys_.b, grid, mesh=mesh, axes=("x", "y"), tol=1e-10
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-10


def test_refined_nonsymmetric_inner_bicgstab():
    """fp64-tolerance NONSYMMETRIC refinement: BiCGStab inner solves on the
    fp32 device, true-fp64 outer contract — plain and mg-preconditioned."""
    from conjugategradient_tpu.core.generators import convection_diffusion_system

    grid = (32, 32)
    sys_ = convection_diffusion_system(grid, eps=0.1)
    x_true = oracle.direct_solve(sys_.A, sys_.b)
    # gridless (plain DIA inner)
    res = refined_solve(sys_.A, sys_.b, tol=1e-9, inner="bicgstab")
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-9
    assert np.linalg.norm(res.x - x_true) / np.linalg.norm(x_true) < 1e-8
    # grid path: V-cycle-right-preconditioned BiCGStab inners
    resg = refined_solve(sys_.A, sys_.b, tol=1e-9, grid=grid, inner="bicgstab")
    assert resg.converged
    rg = sys_.b - oracle.spmv(sys_.A, resg.x)
    assert np.linalg.norm(rg) < 1e-9
    assert resg.inner_iterations < res.inner_iterations


def test_refined_nonsym_device_residual():
    """device_residual=True with BiCGStab inners: the dd outer pass is
    symmetry-agnostic, so the all-on-device refinement loop carries
    nonsymmetric systems too (plain and grid/mg-preconditioned)."""
    from conjugategradient_tpu.core.generators import (
        convection_diffusion_system,
        nonsymmetric_banded_system,
    )

    sys_ = nonsymmetric_banded_system(2048, 16)
    res = refined_solve(
        sys_.A, sys_.b, tol=1e-10, inner="bicgstab", device_residual=True,
    )
    assert res.converged
    r = sys_.b - oracle.spmv(sys_.A, res.x)
    assert np.linalg.norm(r) < 1e-10
    sysc = convection_diffusion_system((32, 32), eps=0.1)
    resg = refined_solve(
        sysc.A, sysc.b, tol=1e-10, grid=(32, 32), inner="bicgstab",
        device_residual=True, smoother="jacobi",
    )
    assert resg.converged
    rg = sysc.b - oracle.spmv(sysc.A, resg.x)
    assert np.linalg.norm(rg) < 1e-10


def test_refined_inner_bicgstab_guards():
    from conjugategradient_tpu.core.generators import convection_diffusion_system

    sys_ = convection_diffusion_system((8, 8), eps=0.5)
    with pytest.raises(ValueError, match="deflation requires"):
        refined_solve(
            sys_.A, sys_.b, inner="bicgstab", device_residual=True,
            deflation=object(),
        )
    try:
        refined_solve(sys_.A, sys_.b, inner="qmr")
        raise AssertionError("expected ValueError")
    except ValueError:
        pass
