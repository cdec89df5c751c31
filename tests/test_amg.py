"""Algebraic (smoothed-aggregation) multigrid: the grid-free MGCG.

Differential strategy (SURVEY.md §4): every AMG solve is validated against
the fp64 oracle, and the algebraic claim is pinned by a random symmetric
permutation — the SAME matrix with its grid structure destroyed must
converge in the same few iterations (a geometric hierarchy cannot even be
built for it).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from conjugategradient_tpu import solve
from conjugategradient_tpu.core import oracle
from conjugategradient_tpu.core.formats import dia_to_csr
from conjugategradient_tpu.core.generators import (
    convection_diffusion_system,
    poisson_system,
)
from conjugategradient_tpu.core.io import from_scipy, to_scipy
from conjugategradient_tpu.precond.amg import (
    _aggregate,
    _strength_graph,
    amg_cg_solve,
    build_amg_hierarchy,
)
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def _poisson_csr(grid=(63, 63)):
    sys_ = poisson_system(grid)
    return dia_to_csr(sys_.A), sys_


def test_amg_cg_poisson_csr():
    """AMG-PCG on 2-D Poisson handed over as bare CSR (no grid)."""
    A_csr, sys_ = _poisson_csr()
    res, h = amg_cg_solve(A_csr, sys_.b, policy=ConvergencePolicy(tol=1e-10))
    assert bool(res.converged)
    assert int(res.iterations) <= 25  # MGCG-strength, not Jacobi-strength
    assert h.n_levels >= 3  # it actually coarsened
    x_ref = oracle.cg(sys_.A, sys_.b, tol=1e-12).x
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-7, atol=1e-9)


def test_amg_beats_plain_cg_iterations():
    A_csr, sys_ = _poisson_csr()
    plain = solve(A_csr, sys_.b, method="cg", tol=1e-8)
    amg = solve(A_csr, sys_.b, method="amg_cg", tol=1e-8)
    assert bool(amg.converged) and bool(plain.converged)
    assert int(amg.iterations) * 5 < int(plain.iterations)


def test_amg_survives_permutation():
    """P A P^T with a random permutation: no banded/grid structure remains,
    iteration count must stay in the same ballpark (the algebraic claim)."""
    A_csr, sys_ = _poisson_csr()
    n = sys_.n
    rng = np.random.default_rng(7)
    perm = rng.permutation(n)
    Pm = sp.csr_matrix((np.ones(n), (perm, np.arange(n))), shape=(n, n))
    A_p = (Pm @ to_scipy(A_csr) @ Pm.T).tocsr()
    b_p = np.asarray(sys_.b)[np.argsort(perm)]  # (P A P^T)(P x) = P b

    res = solve(from_scipy(A_p), b_p, method="amg_cg", tol=1e-10)
    assert bool(res.converged) and int(res.iterations) <= 30
    x_ref = oracle.cg(sys_.A, sys_.b, tol=1e-12).x
    np.testing.assert_allclose(
        np.asarray(res.x), x_ref[np.argsort(perm)], rtol=1e-7, atol=1e-9
    )


def test_amg_near_null_candidate():
    """Symmetric diagonal rescaling S A S: the near-kernel becomes S^{-1}*1.
    Telling setup about it must keep the solver at Poisson-like counts."""
    A_csr, sys_ = _poisson_csr((31, 31))
    n = sys_.n
    rng = np.random.default_rng(3)
    s = np.exp(rng.uniform(-2.0, 2.0, n))  # 4 decades of row scaling
    S = sp.diags(s)
    A_s = (S @ to_scipy(A_csr) @ S).tocsr()
    x_true = rng.standard_normal(n)
    b = A_s @ x_true

    res = solve(from_scipy(A_s), b, method="amg_cg", tol=1e-10, near_null=1.0 / s)
    assert bool(res.converged) and int(res.iterations) <= 35
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6, atol=1e-8)


def test_amg_bicgstab_convection_diffusion():
    """Nonsymmetric: Jacobi-smoothed hierarchy on A itself, right-
    preconditioned BiCGStab (the grid-free analogue of mg_bicgstab);
    measured 660 -> 12 iterations."""
    grid = (63, 63)
    sys_ = convection_diffusion_system(grid, eps=0.1)
    A_csr = dia_to_csr(sys_.A)
    plain = solve(A_csr, sys_.b, method="bicgstab", tol=1e-8, norm="rel_l2")
    # tol 1e-9: with the r5 auto-UNSMOOTHED nonsym P (the 255^2+ divergence
    # cure) the preconditioner is weaker, so the kappa*tol error bound needs
    # one more decade to keep the spsolve comparison at rtol 1e-4
    res = solve(A_csr, sys_.b, method="amg_bicgstab", tol=1e-9, norm="rel_l2")
    assert bool(res.converged)
    assert int(res.iterations) * 10 < int(plain.iterations)
    x_ref = sp.linalg.spsolve(to_scipy(sys_.A).tocsc(), np.asarray(sys_.b))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-4, atol=1e-6)


def test_amg_multi_rhs():
    A_csr, sys_ = _poisson_csr((31, 31))
    rng = np.random.default_rng(0)
    B = rng.standard_normal((sys_.n, 4))
    res = solve(A_csr, B, method="amg_cg", tol=1e-10)
    assert bool(np.asarray(res.converged).all())
    for j in range(4):
        x_ref = oracle.cg(sys_.A, B[:, j], tol=1e-12).x
        np.testing.assert_allclose(
            np.asarray(res.x)[:, j], x_ref, rtol=1e-6, atol=1e-8
        )


def test_amg_minres_route():
    A_csr, sys_ = _poisson_csr((31, 31))
    res = solve(A_csr, sys_.b, method="amg_minres", tol=1e-10)
    assert bool(res.converged) and int(res.iterations) <= 30
    x_ref = oracle.cg(sys_.A, sys_.b, tol=1e-12).x
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-6, atol=1e-8)


def test_aggregation_covers_every_node():
    A_csr, _ = _poisson_csr((17, 19))
    S = _strength_graph(to_scipy(A_csr).tocsr(), theta=0.0)
    agg, n_agg = _aggregate(S)
    assert (agg >= 0).all() and agg.max() == n_agg - 1
    assert n_agg < agg.shape[0] / 3  # genuine coarsening (5-point: ~1/5)


def test_strength_filter_theta():
    # anisotropic 1-D chain embedded in 2-D: weak couplings dropped
    A = sp.csr_matrix(
        np.array(
            [
                [2.0, -1.0, -0.01],
                [-1.0, 2.0, -0.01],
                [-0.01, -0.01, 2.0],
            ]
        )
    )
    S = _strength_graph(A, theta=0.1)
    assert S.nnz == 5  # 3 diagonal + the two strong -1 couplings


def test_stagnation_guard_diagonal_matrix():
    """A diagonal matrix aggregates into singletons; coarsening must stop
    (0 levels) and the dense coarse solve still answers correctly."""
    n = 300
    rng = np.random.default_rng(1)
    d = rng.uniform(1.0, 2.0, n)
    h = build_amg_hierarchy(sp.diags(d).tocsr(), max_coarse=200)
    assert len(h.levels) == 0
    b = rng.standard_normal(n)
    from conjugategradient_tpu.precond.amg import amg_vcycle
    import jax.numpy as jnp

    np.testing.assert_allclose(
        np.asarray(amg_vcycle(h, jnp.asarray(b))), b / d, rtol=1e-10
    )


def test_amg_rejects_nonpositive_diagonal():
    A = sp.csr_matrix(np.array([[1.0, 0.0], [0.0, -1.0]]))
    with pytest.raises(ValueError, match="non-positive diagonal"):
        build_amg_hierarchy(A, max_coarse=1)


def test_amg_fgmres_gets_jacobi_smoother():
    """Review finding: amg_fgmres missed the nonsym jacobi-smoother default
    and silently got the chebyshev smoother (which diverges on nonsym
    spectra — measured rel err 1.7e-1 vs 7.3e-7).  Must converge like
    amg_gmres now."""
    grid = (63, 63)
    sys_ = convection_diffusion_system(grid, eps=0.1)
    A_csr = dia_to_csr(sys_.A)
    res = solve(
        A_csr, sys_.b, method="amg_fgmres", tol=1e-9, norm="rel_l2",
        restart=20,
    )
    assert bool(res.converged)
    x_ref = sp.linalg.spsolve(to_scipy(sys_.A).tocsc(), np.asarray(sys_.b))
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-4, atol=1e-6)


def test_amg_level_operator_relayout():
    """layout='auto' puts banded-structure levels in DIA (static shifted
    slices instead of CSR gathers) and keeps genuinely irregular (permuted)
    levels in CSR; layout='csr' forces CSR."""
    import scipy.sparse as sp

    from conjugategradient_tpu.core.formats import CsrMatrix, DiaMatrix
    from conjugategradient_tpu.core.generators import banded_sin_matrix, poisson_system
    from conjugategradient_tpu.core.io import from_scipy, to_scipy

    def generators_banded_sin(n, band):
        return from_scipy(to_scipy(banded_sin_matrix(n, band)).tocsr())

    sys_ = poisson_system((31, 31))
    A_csr = from_scipy(to_scipy(sys_.A).tocsr())
    h = build_amg_hierarchy(A_csr, dtype=np.float64)
    # r5: grid-inferred levels relayout all the way onto the STENCIL fast
    # path (const-detected here — the Poisson coefficients are constant)
    from conjugategradient_tpu.core.formats import (
        ConstStencilMatrix,
        StencilMatrix,
    )

    assert isinstance(h.levels[0].A, (ConstStencilMatrix, StencilMatrix))
    # flat banded input (no inferable grid) still lands in DIA
    bs = generators_banded_sin(4096, 16)
    h_dia = build_amg_hierarchy(bs, dtype=np.float64)
    assert isinstance(h_dia.levels[0].A, DiaMatrix)
    h_csr = build_amg_hierarchy(A_csr, dtype=np.float64, layout="csr")
    assert all(isinstance(l.A, CsrMatrix) for l in h_csr.levels)
    # identical trajectories either way (same arithmetic, different layout)
    r1, _ = amg_cg_solve(A_csr, sys_.b, hierarchy=h)
    r2, _ = amg_cg_solve(A_csr, sys_.b, hierarchy=h_csr)
    assert int(r1.iterations) == int(r2.iterations)

    S = to_scipy(sys_.A).tocsr()
    perm = np.random.default_rng(3).permutation(S.shape[0])
    Pm = sp.csr_matrix((np.ones(len(perm)), (np.arange(len(perm)), perm)), shape=S.shape)
    hp = build_amg_hierarchy((Pm @ S @ Pm.T).tocsr(), dtype=np.float64)
    assert isinstance(hp.levels[0].A, CsrMatrix)  # no bandable structure


def test_blocked_aggregation_gather_free_and_auto_gates():
    """Round-4/5: contiguous (blocked) aggregation — restrict is a
    reshape-sum, prolong a broadcast (no gathers), every Galerkin level
    stays DIA (no CSR tail).  Round-5 upgrade: grid-like offset structure
    is detected (``_infer_grid``) and gets N-D CUBE blocks (edge 3) — the
    Galerkin stencil stays invariant down the hierarchy (measured 511^2:
    ndiags 5->9->9 vs the 1-D strips' 5->17->53->161->325) and NONSYMMETRIC
    operators ride the same zero-gather cycle (cubes are isotropic; the
    measured-bad strips stay gated to symmetric smoothed levels)."""
    import numpy as np

    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.core.formats import DiaMatrix, dia_to_csr
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    sys_ = generators.poisson_system((63, 63))
    csr = from_scipy(to_scipy(sys_.A).tocsr())
    h = build_amg_hierarchy(csr)  # auto -> ND-blocked (grid inferred)
    assert all(l.blk_nd is not None for l in h.levels)
    assert h.levels[0].blk_nd == ((63, 63), (3, 3))
    # ND levels relayout onto the stencil fast path (const-detected for
    # the constant-coefficient Poisson levels)
    from conjugategradient_tpu.core.formats import (
        ConstStencilMatrix as _CSt,
        StencilMatrix as _St,
    )

    assert all(isinstance(l.A, (_St, _CSt, DiaMatrix)) for l in h.levels)
    assert isinstance(h.levels[0].A, (_St, _CSt))
    pol = ConvergencePolicy(tol=1e-9, norm="rel_l2", max_iteration=200)
    res, _ = amg_cg_solve(csr, sys_.b, policy=pol, hierarchy=h)
    assert bool(res.converged)
    x_true = oracle.direct_solve(sys_.A, sys_.b)
    rel = np.linalg.norm(np.asarray(res.x) - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-7

    # nonsymmetric grid-structured auto now gets ND blocks too (r5: the
    # auto-unsmoothed P makes the composition transfers exact without
    # symmetry); a flat NONSYM band (no grid) falls back to greedy
    cd = generators.convection_diffusion_matrix((31, 31), eps=0.1)
    h_cd = build_amg_hierarchy(dia_to_csr(cd), smoother="jacobi")
    assert all(l.blk_nd is not None for l in h_cd.levels)
    assert h_cd.levels[0].sa_c == 0.0  # auto-unsmoothed on nonsym
    nb = generators.nonsymmetric_banded_matrix(512, 8)
    h_nb = build_amg_hierarchy(dia_to_csr(nb), smoother="jacobi")
    assert all(l.blk == 0 and l.blk_nd is None for l in h_nb.levels)

    # explicit 1-D blocked on request, any blk (flat-band form: use a
    # workload with no inferable grid so the strips actually engage)
    bs = generators.banded_sin_matrix(4096, 16)
    bs_csr = from_scipy(to_scipy(bs).tocsr())
    h6 = build_amg_hierarchy(bs_csr, aggregation="blocked", blk=6)
    assert all(l.blk == 6 for l in h6.levels)
    bvec = np.ones(4096)
    res6, _ = amg_cg_solve(bs_csr, bvec, policy=pol, hierarchy=h6)
    assert bool(res6.converged)


def test_nd_blocked_matches_generic_composition_cycle():
    """The blk_nd reshape-sum/broadcast transfers must compute EXACTLY what
    the generic agg/w composition path computes (same algebra, different
    lowering) — strip blk_nd from the levels and compare one V-cycle."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond.amg import amg_vcycle

    for grid in [(31, 31), (13, 13, 13)]:
        sys_ = generators.poisson_system(grid)
        csr = from_scipy(to_scipy(sys_.A).tocsr())
        h = build_amg_hierarchy(csr, max_coarse=50)
        assert h.levels and all(l.blk_nd is not None for l in h.levels)
        h_generic = dataclasses.replace(
            h,
            levels=tuple(
                dataclasses.replace(l, blk_nd=None) for l in h.levels
            ),
        )
        b = jnp.asarray(np.asarray(sys_.b))
        y_nd = np.asarray(amg_vcycle(h, b))
        y_gen = np.asarray(amg_vcycle(h_generic, b))
        np.testing.assert_allclose(y_nd, y_gen, rtol=1e-12, atol=1e-13)


def test_nd_blocked_nonsym_beats_greedy_iterations():
    """Measured r5 (255^2/511^2 convection eps=0.05: ND 67/52 its vs greedy
    110/144): cube aggregates with unsmoothed P converge at least as fast
    as greedy on convection — pinned here at CI scale."""
    import jax.numpy as jnp
    import numpy as np

    from conjugategradient_tpu.core.generators import convection_diffusion_system
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond.amg import amg_preconditioner
    from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    sys_ = convection_diffusion_system((63, 63), eps=0.05)
    A_csr = from_scipy(to_scipy(sys_.A).tocsr())
    b = jnp.asarray(np.asarray(sys_.b))
    pol = ConvergencePolicy(tol=1e-8, norm="rel_l2", max_iteration=2000)
    its = {}
    for aggname in ("greedy", "auto"):
        h = build_amg_hierarchy(
            A_csr, smoother="jacobi", aggregation=aggname
        )
        res = bicgstab_solve(h.levels[0].A, b, policy=pol, M=amg_preconditioner(h))
        assert bool(res.converged)
        its[aggname] = int(res.iterations)
    assert its["auto"] <= 1.5 * its["greedy"]


def test_infer_grid_prefers_exact_pitch_and_seam_validation():
    """Review findings: (a) candidate order must prefer the axis-aligned
    jump offset — plain sorted() mis-inferred (9, 12) as (12, 9) whenever
    pitch-3 divides n; (b) a divisible-but-wrong pitch (flat {1,2,5} band
    with 8 | n) must be rejected by the operator's row-seam validation, and
    (c) explicit aggregation='blocked' keeps the caller's 1-D strips even
    on grid inputs."""
    import scipy.sparse as sp

    from conjugategradient_tpu.core.generators import poisson_system
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond.amg import _infer_grid

    assert _infer_grid(9 * 12, [1, 12]) == (9, 12)
    assert _infer_grid(10 * 12, [1, 11, 12, 13]) == (10, 12)

    # (b): a flat band whose fake pitch divides n — seam validation refuses
    n = 512
    diags_ = {0: 4.0, 1: -1.0, -1: -1.0, 2: -0.5, -2: -0.5, 5: -0.25, -5: -0.25}
    Ab = sp.diags(
        [np.full(n - abs(o), v) for o, v in diags_.items()],
        list(diags_.keys()),
    ).tocsr()
    h_b = build_amg_hierarchy(from_scipy(Ab), dtype=np.float64)
    assert all(l.blk_nd is None for l in h_b.levels)

    # (c): explicit strips honoured on a grid input
    sys_ = poisson_system((31, 31))
    csr = from_scipy(to_scipy(sys_.A).tocsr())
    h_s = build_amg_hierarchy(csr, aggregation="blocked", blk=6)
    assert all(l.blk == 6 and l.blk_nd is None for l in h_s.levels)
