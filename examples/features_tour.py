"""One-stop tour of the framework beyond the reference's surface.

Runs, in order, each round-2 capability on small CPU-fast systems with an
oracle check after every step — a single entry point to validate (and read
as executable documentation):

  1. one-call facade across methods (cg / jacobi_cg / cheb_cg / mgcg)
  2. spectral diagnostics from a solve's own scalars (kappa before/after M)
  3. multi-RHS block solves through the facade ((n, k) b)
  4. communication-reduced distributed variants (cg1 / pipelined)
  5. flat-band sharded block CG (one (k,)-psum per iteration)
  6. mixed precision: fp64 tolerance on fp32 state via refinement, with an
     optionally bf16-stored matrix stream
  7. variable-coefficient diffusion (-div(a grad u), jump field) solved by
     MGCG with hybrid transfers + bf16 stencil legs under refinement
  8. multi-RHS refinement: a whole (n, k) block to fp64 tolerance, one
     matrix stream per inner iteration
  9. deflated CG: outlier eigenmodes probed once (device Lanczos),
     removed from every solve of a sequence
 10. device-resident refinement: the fp64-grade outer loop runs ON the
     device in double-float (two-fp32) arithmetic — scalar-only readbacks
 11. mesh-partitioned refinement: the dd outer pass AND the GSPMD MGCG
     inner solve sharded over the same device mesh (fp64 tolerance at
     distributed scale, three scalar readbacks per pass)
 12. nonsymmetric systems: convection-diffusion solved by BiCGStab and
     restarted GMRES (CG is shown failing on the same operator)
 13. LOBPCG block eigensolver: smallest eigenpairs of the Poisson
     operator, multigrid-preconditioned, vs the closed-form spectrum
 14. symmetric indefinite (Helmholtz): MINRES converges monotonically
     where CG's residual spikes orders of magnitude
 15. functional transforms over solves: jax.vmap batches a parameter
     sweep into one program; jax.grad differentiates THROUGH a solve
     (implicit adjoint = one extra CG solve, O(n) memory)
 16. convection-dominated transport (round 3): Galerkin coarsening shown
     DIVERGING at 127x127 cell-Peclet 20, rediscretized upwind coarse
     operators converging grid-independently; FGMRES with a fixed-budget
     inner BiCGStab solve as the (nonlinear) preconditioner
 17. CA-CG: s-step communication-avoiding CG — one fused Gram reduction
     per s iterations, iterate-for-iterate the CG sequence
 18. anisotropic diffusion: auto-semicoarsening (full coarsening shown
     degrading 17x at 1000:1 coupling; per-axis transfers restore it)
 19. distributed ALGEBRAIC multigrid (amg_cg + mesh= on a matrix with no
     grid), multi-RHS block BiCGStab, and jax.grad through a NONSYMMETRIC
     solve (transposed-operator adjoint)
 20. rectangular least squares (LSMR, method='auto' routing) and the
     generalized eigenproblem A x = lam B x (B-inner-product LOBPCG)
 21. the eigs facade (nonsymmetric Krylov-Schur with complex pairs +
     symmetric LOBPCG auto-routing) and distributed LSMR least squares
     (A and A^T halo SpMVs over the mesh, 2 psums/iteration)

Run:  python examples/features_tour.py            (8 virtual devices, CPU)
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from conjugategradient_tpu import solve
    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    ok = True

    def check(label, x, sys_, tol=1e-7):
        nonlocal ok
        r = sys_.b - oracle.spmv(sys_.A, np.asarray(x, np.float64).reshape(sys_.b.shape))
        rel = np.linalg.norm(r.ravel()) / np.linalg.norm(sys_.b.ravel())
        good = rel < tol
        ok &= good
        print(f"  [{'OK ' if good else 'BAD'}] {label:<46} true rel residual {rel:.2e}")
        return rel

    # 1. facade methods ---------------------------------------------------
    print("1. one-call facade (banded |sin| n=1024, band 16):")
    sys_ = generators.banded_sin_system(1024, 16)
    its = {}
    for method, kw in (
        ("cg", {}),
        ("jacobi_cg", {}),
        ("cheb_cg", {"degree": 3}),
        ("chebyshev", {"max_iteration": 20000}),  # dot-free fixed polynomial
    ):
        res = solve(sys_.A, sys_.b, sys_.x0, method=method, tol=1e-10, norm="rel_l2", **kw)
        its[method] = int(res.iterations)
        check(f"{method} ({its[method]} iterations)", res.x, sys_)
    assert its["cheb_cg"] < its["jacobi_cg"] < its["cg"] <= its["chebyshev"], its

    grid = (63, 63)
    psys = generators.poisson_system(grid)
    res = solve(psys.A, psys.b, method="mgcg", grid=grid, tol=1e-10, norm="rel_l2")
    check(f"mgcg ({int(res.iterations)} iterations vs {its['cg']} plain on the band)", res.x, psys)

    # 2. spectrum probe ---------------------------------------------------
    print("2. spectral diagnostics from the solve itself (63x63 Poisson):")
    from conjugategradient_tpu.precond import build_hierarchy
    from conjugategradient_tpu.precond.multigrid import v_cycle
    from conjugategradient_tpu.solvers.cg import cg_solve_traced
    from conjugategradient_tpu.solvers.eigen import spectrum_from_cg
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    A_dev = psys.A.device_put()
    b_dev = jnp.asarray(psys.b)
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=400)
    h = build_hierarchy(psys.A, grid)
    kappas = {}
    for label, M in (("A", None), ("M^-1 A", (v_cycle, h))):
        tres, _, (al, be) = cg_solve_traced(
            A_dev, b_dev, policy=pol, M=M, num_steps=300, with_coefficients=True
        )
        lo, hi, kappas[label] = spectrum_from_cg(al, be, int(tres.iterations))
        print(f"  spectrum({label}): [{lo:.3e}, {hi:.3e}]  kappa ~ {kappas[label]:.1f}")
    assert kappas["M^-1 A"] < 2.0 < kappas["A"], kappas

    # 3. multi-RHS through the facade ------------------------------------
    print("3. multi-RHS block solve ((n, 4) right-hand sides, one matrix stream):")
    rng = np.random.default_rng(0)
    B = rng.standard_normal((sys_.n, 4))
    mres = solve(sys_.A, B, method="cg", tol=1e-10, norm="rel_l2")
    worst = 0.0
    for j in range(4):
        r = B[:, j] - oracle.spmv(sys_.A, np.asarray(mres.x[:, j], np.float64))
        worst = max(worst, np.linalg.norm(r) / np.linalg.norm(B[:, j]))
    good = worst < 1e-8
    ok &= good
    print(f"  [{'OK ' if good else 'BAD'}] 4 columns, iterations {np.asarray(mres.iterations).tolist()}, worst rel {worst:.2e}")

    # 4. communication-reduced distributed variants -----------------------
    print("4. sharded CG variants (8 virtual devices):")
    from conjugategradient_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    for variant in ("cg", "cg1", "pipelined"):
        res = solve(
            sys_.A, sys_.b, sys_.x0, method="sharded_cg", tol=1e-10, norm="rel_l2",
            mesh=mesh, variant=variant,
        )
        check(f"sharded_cg variant={variant} ({int(res.iterations)} it)", res.x, sys_)

    # 5. flat-band sharded block CG ---------------------------------------
    print("5. flat-band sharded block CG (k=3, one (k,)-psum per iteration):")
    from conjugategradient_tpu.parallel.shard_multi import sharded_cg_multi_solve

    B3 = rng.standard_normal((sys_.n, 3))
    bres = sharded_cg_multi_solve(
        sys_.A, B3, policy=ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=2000),
        mesh=mesh,
    )
    worst = 0.0
    for j in range(3):
        r = B3[:, j] - oracle.spmv(sys_.A, np.asarray(bres.x[:, j], np.float64))
        worst = max(worst, np.linalg.norm(r) / np.linalg.norm(B3[:, j]))
    good = worst < 1e-8 and bool(np.asarray(bres.converged).all())
    ok &= good
    print(f"  [{'OK ' if good else 'BAD'}] iterations {np.asarray(bres.iterations).tolist()}, worst rel {worst:.2e}")

    # 6. mixed precision ---------------------------------------------------
    print("6. fp64 tolerance on fp32 state (+ bf16 matrix stream) via refinement:")
    from conjugategradient_tpu.solvers.refine import refined_solve

    rsys = generators.banded_sin_system(4096, 32)
    for label, kw in (
        ("fp32 inner", {}),
        ("bf16 matrix stream", {"matrix_dtype": jnp.bfloat16}),
    ):
        rres = refined_solve(rsys.A, rsys.b, rsys.x0, tol=1e-8, norm="l2", **kw)
        r = rsys.b - oracle.spmv(rsys.A, rres.x)
        good = rres.converged and np.linalg.norm(r) < 1e-8
        ok &= good
        print(
            f"  [{'OK ' if good else 'BAD'}] {label:<24} abs residual "
            f"{np.linalg.norm(r):.2e} in {rres.outer_iterations} outer / "
            f"{rres.inner_iterations} inner"
        )

    # 7. variable-coefficient diffusion ------------------------------------
    print("7. jump-coefficient diffusion (-div(a grad u), 64x64, a-ratio 1e4):")
    dgrid = (64, 64)
    dsys = generators.diffusion_system(dgrid, kind="jump", contrast=1e4, seed=1)
    dres = solve(dsys.A, dsys.b, method="mgcg", grid=dgrid, tol=1e-10, norm="rel_l2")
    check(f"mgcg on jump coefficients ({int(dres.iterations)} it)", dres.x, dsys)
    # bf16 legs are a ~4e-3 relative operator perturbation: refinement
    # contracts only while kappa(A) * 2^-8 < 1, so the narrow-leg demo uses
    # the smooth field (the 1e4-contrast jump operator above is out of the
    # bf16 envelope and refined_solve would honestly report stalled)
    ssys = generators.diffusion_system(dgrid, kind="smooth", seed=7)
    rres = refined_solve(
        ssys.A, ssys.b, tol=1e-9, grid=dgrid, matrix_dtype=jnp.bfloat16
    )
    r = ssys.b - oracle.spmv(ssys.A, rres.x)
    good = rres.converged and np.linalg.norm(r) < 1e-9
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] bf16 stencil legs + refinement (smooth a) abs "
        f"residual {np.linalg.norm(r):.2e} in {rres.outer_iterations} outer"
    )

    # 8. multi-RHS refinement ----------------------------------------------
    print("8. multi-RHS refinement ((n, 3) block to fp64 tolerance):")
    B3r = rng.standard_normal((psys.A.n, 3))
    mref = solve(psys.A, B3r, method="refined", tol=1e-10, grid=grid)
    worst = 0.0
    for j in range(3):
        r = B3r[:, j] - oracle.spmv(psys.A, mref.x[:, j])
        worst = max(worst, float(np.linalg.norm(r)))
    good = bool(mref.converged.all()) and worst < 1e-10
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] 3 columns in {mref.outer_iterations} outer / "
        f"{mref.inner_iterations.tolist()} inner, worst abs residual {worst:.2e}"
    )

    # 9. deflated CG on an outlier spectrum --------------------------------
    print("9. deflated CG (4 isolated tiny eigenmodes, kappa ~ 1e6):")
    osys = generators.outlier_system(4096, band=16, n_outliers=4, scale=1e-3)
    pol_kw = dict(method="cg", tol=1e-8, norm="rel_l2", precise_dot=True)
    plain = solve(osys.A, osys.b, **pol_kw)
    defl = solve(
        osys.A, osys.b, method="deflated_cg", tol=1e-8, norm="rel_l2",
        k=8, m=48, precise_dot=True,
    )
    r = osys.b - oracle.spmv(osys.A, np.asarray(defl.x, np.float64))
    good = (
        bool(defl.converged)
        and int(defl.iterations) <= int(plain.iterations) // 2
        and np.linalg.norm(r) / np.linalg.norm(osys.b) < 1e-7
    )
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] {int(defl.iterations)} iterations vs "
        f"{int(plain.iterations)} plain, true rel residual "
        f"{np.linalg.norm(r) / np.linalg.norm(osys.b):.2e}"
    )

    # 10. device-resident (double-float) refinement -------------------------
    print("10. device-resident refinement (dd outer loop, scalar readbacks):")
    rres = solve(
        rsys.A, rsys.b, rsys.x0, method="refined", tol=1e-8,
        device_residual=True,
    )
    r = rsys.b - oracle.spmv(rsys.A, rres.x)
    good = rres.converged and np.linalg.norm(r) < 1e-8
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] abs residual {np.linalg.norm(r):.2e} in "
        f"{rres.outer_iterations} outer / {rres.inner_iterations} inner"
    )

    # 11. mesh-partitioned refinement ---------------------------------------
    print("11. mesh-partitioned refinement (dd outer + GSPMD MGCG inner, 2x1 mesh):")
    mgrid = (63, 63)
    msys = generators.poisson_system(mgrid)
    mesh2 = make_mesh(2)
    gres = solve(
        msys.A, msys.b, method="refined", tol=1e-10, grid=mgrid, mesh=mesh2,
    )
    r = msys.b.ravel() - oracle.spmv(msys.A, np.asarray(gres.x, np.float64).ravel())
    good = gres.converged and np.linalg.norm(r) < 1e-10
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] abs residual {np.linalg.norm(r):.2e} in "
        f"{gres.outer_iterations} outer / {gres.inner_iterations} inner "
        f"(sharded over {mesh2.devices.size} devices)"
    )

    # 12. nonsymmetric systems --------------------------------------------
    print("12. nonsymmetric convection-diffusion (24x24, recirculating v, Pe=20):")
    csys = generators.convection_diffusion_system((24, 24), eps=0.05)
    x_true = oracle.direct_solve(csys.A, csys.b)
    cg_try = solve(csys.A, csys.b, method="cg", tol=1e-10, norm="rel_l2",
                   max_iteration=600)
    cg_err = np.linalg.norm(np.asarray(cg_try.x, np.float64) - x_true) / np.linalg.norm(x_true)
    for method, kw in (("bicgstab", {}), ("gmres", {"restart": 30, "max_iteration": 4000})):
        res = solve(csys.A, csys.b, method=method, tol=1e-10, norm="rel_l2", **kw)
        err = np.linalg.norm(np.asarray(res.x, np.float64) - x_true) / np.linalg.norm(x_true)
        good = bool(res.converged) and err < 1e-7 and cg_err > 1e-8
        ok &= good
        print(
            f"  [{'OK ' if good else 'BAD'}] {method:<9} {int(res.iterations):>5} it, "
            f"rel err vs direct {err:.2e} (CG stalls at {cg_err:.2e})"
        )

    # 13. LOBPCG block eigensolver ----------------------------------------
    print("13. LOBPCG (4 smallest eigenpairs of 63x63 Poisson, V-cycle M):")
    from conjugategradient_tpu.solvers.lobpcg import lobpcg
    from conjugategradient_tpu.solvers.multi import as_multi_preconditioner

    eres = lobpcg(psys.A, 4, M=as_multi_preconditioner(h), tol=1e-9,
                  max_iterations=200, dtype=jnp.float64)
    lam_exact = np.sort(np.add.outer(
        4 * np.sin(np.pi * np.arange(1, 64) / 128) ** 2,
        4 * np.sin(np.pi * np.arange(1, 64) / 128) ** 2,
    ).ravel())[:4]
    lam = np.sort(np.asarray(eres.eigenvalues, np.float64))
    good = bool(eres.converged) and np.allclose(lam, lam_exact, rtol=1e-6)
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] {int(eres.iterations)} iterations, "
        f"eigenvalues {np.array2string(lam, precision=6)} "
        f"(closed form {np.array2string(lam_exact, precision=6)})"
    )

    # 14. symmetric indefinite: MINRES ------------------------------------
    # shift 0.05 on the n=256 1-D Laplacian sits above its ~7 smallest
    # eigenvalues — deep enough indefiniteness that CG visibly spikes
    print("14. Helmholtz (-lap - 0.05, n=256, indefinite): MINRES vs CG:")
    hsys = generators.helmholtz_system((256,), shift=0.05)
    hx_true = oracle.direct_solve(hsys.A, hsys.b)
    from conjugategradient_tpu.solvers.cg import cg_solve_traced

    _, cg_hist = cg_solve_traced(
        hsys.A.device_put(), jnp.asarray(hsys.b),
        policy=ConvergencePolicy(tol=1e-10, norm="rel_l2"), num_steps=200,
    )
    mres = solve(hsys.A, hsys.b, method="minres", tol=1e-10, norm="rel_l2",
                 max_iteration=4000)
    herr = np.linalg.norm(np.asarray(mres.x) - hx_true) / np.linalg.norm(hx_true)
    spike = float(np.max(np.asarray(cg_hist)))
    good = bool(mres.converged) and herr < 1e-7 and spike > 10.0
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] MINRES {int(mres.iterations)} it, rel err "
        f"{herr:.2e}; CG's relative residual spiked to {spike:.1f} on the way"
    )

    # 15. transforms over solves ------------------------------------------
    print("15. transforms: vmap'd parameter sweep + grad through a solve:")
    from conjugategradient_tpu.core.formats import DiaMatrix
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.diff import cg_solve_implicit

    tsys = generators.banded_sin_system(256, 8)
    offs, tshape = tsys.A.offsets, tsys.A.shape
    tpol = ConvergencePolicy(tol=1e-11, norm="rel_l2")
    scales = 1.0 + 0.1 * np.arange(4)
    datas = jnp.asarray(np.stack([np.asarray(tsys.A.data) * s for s in scales]))
    bs = jnp.asarray(np.tile(tsys.b, (4, 1)))
    sweep = jax.jit(
        jax.vmap(lambda d, b_: cg_solve(DiaMatrix(d, offs, tshape), b_, policy=tpol))
    )(datas, bs)
    worst = 0.0
    for j, s in enumerate(scales):
        Aj = generators.DiaMatrix(np.asarray(datas[j]), offs, tshape)
        r = tsys.b - oracle.spmv(Aj, np.asarray(sweep.x[j]))
        worst = max(worst, np.linalg.norm(r))
    good = bool(np.asarray(sweep.converged).all()) and worst < 1e-8
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] vmap sweep over 4 operator scales in one "
        f"program, worst abs residual {worst:.2e}"
    )

    data0 = jnp.asarray(np.asarray(tsys.A.data))
    b0 = jnp.asarray(tsys.b)
    w = jnp.asarray(np.cos(0.1 * np.arange(tsys.n)))
    lossf = lambda b_: jnp.vdot(w, cg_solve_implicit(data0, b_, offs, tshape, tpol))
    g = jax.grad(lossf)(b0)
    d = np.random.default_rng(5).standard_normal(tsys.n)
    eps = 1e-6
    fd = (float(lossf(b0 + eps * d)) - float(lossf(b0 - eps * d))) / (2 * eps)
    an = float(jnp.vdot(g, jnp.asarray(d)))
    good = abs(an - fd) < 1e-5 * max(1.0, abs(fd))
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] grad through the solve vs finite "
        f"difference: {an:.6f} vs {fd:.6f}"
    )

    # 16. convection-dominated multigrid + inner-outer Krylov --------------
    print("16. convection at scale: rediscretized coarse ops; FGMRES inner-outer:")
    vgrid = (127, 127)
    vsys = generators.convection_diffusion_system(vgrid, eps=0.05)
    vpol_kw = dict(tol=1e-8, norm="rel_l2", max_iteration=60)
    gal = solve(vsys.A, vsys.b, method="mg_bicgstab", grid=vgrid, **vpol_kw)
    red = solve(
        vsys.A, vsys.b, method="mg_bicgstab", grid=vgrid,
        coarse_operator=generators.convection_diffusion_coarse_operator(eps=0.05),
        **vpol_kw,
    )
    vx = oracle.direct_solve(vsys.A, vsys.b)
    rerr = np.linalg.norm(np.asarray(red.x, np.float64) - vx) / np.linalg.norm(vx)
    good = (not bool(gal.converged)) and bool(red.converged) and rerr < 1e-5
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] 127x127 cell-Peclet-20 transport: "
        f"Galerkin coarsening diverges (it {int(gal.iterations)}), upwind "
        f"rediscretization converges in {int(red.iterations)} it (rel err {rerr:.2e})"
    )

    from conjugategradient_tpu.solvers.gmres import (
        fgmres_solve,
        gmres_solve,
        inner_solve_preconditioner,
    )

    fsys = generators.convection_diffusion_system((24, 24), eps=0.05)
    fA = fsys.A.device_put()
    fpol = ConvergencePolicy(tol=1e-9, norm="rel_l2", max_iteration=4000)
    plain = gmres_solve(fA, jnp.asarray(fsys.b), policy=fpol, restart=30)
    finner = fgmres_solve(
        fA, jnp.asarray(fsys.b), policy=fpol, restart=30,
        M=inner_solve_preconditioner(fA, method="bicgstab", iterations=12),
    )
    fx = oracle.direct_solve(fsys.A, fsys.b)
    ferr = np.linalg.norm(np.asarray(finner.x, np.float64) - fx) / np.linalg.norm(fx)
    good = bool(finner.converged) and ferr < 1e-6 and int(finner.iterations) * 5 < int(
        plain.iterations
    )
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] FGMRES with a 12-step inner BiCGStab "
        f"preconditioner: {int(finner.iterations)} outer it vs {int(plain.iterations)} "
        f"plain GMRES it (rel err {ferr:.2e})"
    )

    # 17. s-step communication-avoiding CG --------------------------------
    print("17. CA-CG: one Gram reduction per s iterations, same Krylov sequence:")
    csys = generators.banded_sin_system(1024, 16)
    cx = oracle.direct_solve(csys.A, csys.b)
    cpol_kw = dict(tol=1e-10, norm="rel_l2")
    ref = solve(csys.A, csys.b, method="cg", **cpol_kw)
    ca = solve(csys.A, csys.b, method="cacg", s=4, **cpol_kw)
    cash = solve(
        csys.A, csys.b, method="cacg", s=4,
        mesh=__import__(
            "conjugategradient_tpu.parallel.mesh", fromlist=["make_mesh"]
        ).make_mesh(8), **cpol_kw,
    )
    cerr = np.linalg.norm(np.asarray(ca.x, np.float64) - cx) / np.linalg.norm(cx)
    good = (
        bool(ca.converged) and bool(cash.converged) and cerr < 1e-8
        and int(ref.iterations) <= int(ca.iterations) < int(ref.iterations) + 4
    )
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] cacg(s=4) {int(ca.iterations)} it vs cg "
        f"{int(ref.iterations)} it (same sequence, block-rounded); sharded twin "
        f"{int(cash.iterations)} it on the 8-mesh — 2 all-reduces + 4 halo "
        f"permutes per 4 iterations (HLO-audited), rel err {cerr:.2e}"
    )

    # 18. anisotropic diffusion: auto-semicoarsening ----------------------
    print("18. anisotropy: full coarsening degrades, semicoarsening does not:")
    agrid = (63, 63)
    asys = generators.anisotropic_diffusion_system(agrid, (0.001, 1.0))
    from conjugategradient_tpu.core.formats import dia_to_stencil as _d2s
    from conjugategradient_tpu.precond import as_preconditioner as _asp
    from conjugategradient_tpu.precond import build_hierarchy as _bh
    from conjugategradient_tpu.solvers.cg import cg_solve as _cgs

    aA = _d2s(asys.A, agrid).device_put()
    ab = jnp.asarray(asys.b).reshape(agrid)
    apol = ConvergencePolicy(tol=1e-9, norm="rel_l2", max_iteration=500)
    full = _cgs(aA, ab, policy=apol, M=_asp(_bh(asys.A, agrid, semicoarsen=False)))
    h_semi = _bh(asys.A, agrid)
    semi = _cgs(aA, ab, policy=apol, M=_asp(h_semi))
    ax_true = oracle.direct_solve(asys.A, asys.b)
    aerr = np.linalg.norm(
        np.asarray(semi.x, np.float64).ravel() - ax_true
    ) / np.linalg.norm(ax_true)
    good = (
        bool(semi.converged) and aerr < 1e-6
        and int(semi.iterations) * 3 < int(full.iterations)
        and any(l.transfer.startswith("semi") for l in h_semi.levels)
    )
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] 1000:1 anisotropy at 63x63: full "
        f"coarsening {int(full.iterations)} it, auto-semicoarsened "
        f"{int(semi.iterations)} it (strong axis only: "
        f"{[l.grid for l in h_semi.levels[:3]]}), rel err {aerr:.2e}"
    )

    # 19. distributed AMG + multi-RHS / differentiable nonsym -------------
    print("19. no-grid distributed AMG; block + differentiable nonsym:")
    from conjugategradient_tpu.core.io import from_scipy, to_scipy

    pgrid = (31, 31)
    psys = generators.poisson_system(pgrid)
    p_csr = from_scipy(to_scipy(psys.A).tocsr())  # grid knowledge discarded
    dres = solve(p_csr, psys.b, method="amg_cg", mesh=mesh, tol=1e-8, norm="rel_l2")
    px_true = oracle.direct_solve(psys.A, psys.b)
    damg_err = np.linalg.norm(
        np.asarray(dres.x, np.float64) - px_true
    ) / np.linalg.norm(px_true)
    good = bool(dres.converged) and damg_err < 1e-6
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] amg_cg + mesh= on 31x31 Poisson-as-CSR "
        f"(row-sharded SA levels, exact-hop ring gathers, no grid given): "
        f"{int(dres.iterations)} it on the 8-mesh, rel err {damg_err:.2e}"
    )

    ngrid = (31, 31)
    nsys = generators.convection_diffusion_system(ngrid, eps=0.1)
    kB = np.random.default_rng(7).standard_normal((nsys.A.n, 3))
    bres = solve(
        nsys.A, kB, method="mg_bicgstab", grid=ngrid, tol=1e-8, norm="rel_l2",
        coarse_operator=generators.convection_diffusion_coarse_operator(eps=0.1),
    )
    bX = np.asarray(bres.x, np.float64)
    berrs = []
    for j in range(3):
        xr = oracle.direct_solve(nsys.A, kB[:, j])
        berrs.append(np.linalg.norm(bX[:, j] - xr) / np.linalg.norm(xr))
    good = bool(np.asarray(bres.converged).all()) and max(berrs) < 1e-6
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] (n, 3) block mg_bicgstab (one SpMM "
        f"pass per half-step serves 3 recurrences): "
        f"{np.asarray(bres.iterations).tolist()} it, max rel err {max(berrs):.2e}"
    )

    from conjugategradient_tpu.solvers.diff import bicgstab_solve_implicit

    dsys = generators.convection_diffusion_system((8, 8), eps=0.3)
    ddata = jnp.asarray(np.asarray(dsys.A.data))
    db = jnp.asarray(np.asarray(dsys.b))
    dpol = ConvergencePolicy(tol=1e-12, norm="rel_l2", max_iteration=4000)

    def dloss(data, b):
        return jnp.sum(
            jnp.sin(bicgstab_solve_implicit(data, b, dsys.A.offsets, dsys.A.shape, dpol))
        )

    g_b = jax.grad(dloss, argnums=1)(ddata, db)
    feps = 1e-6
    bp = np.asarray(db).copy(); bp[3] += feps
    bm = np.asarray(db).copy(); bm[3] -= feps
    fd = (float(dloss(ddata, jnp.asarray(bp))) - float(dloss(ddata, jnp.asarray(bm)))) / (2 * feps)
    gerr = abs(float(g_b[3]) - fd) / max(abs(fd), 1e-30)
    good = gerr < 1e-4
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] grad through a NONSYM solve "
        f"(adjoint = one transposed-operator BiCGStab): d/db[3] ad "
        f"{float(g_b[3]):+.6f} vs fd {fd:+.6f} (rel {gerr:.1e})"
    )

    # 20. least squares + generalized eigenproblem ------------------------
    print("20. rectangular least squares (LSMR); generalized LOBPCG:")
    import scipy.linalg as _sla
    import scipy.sparse as _sp
    import scipy.sparse.linalg as _spla

    from conjugategradient_tpu.core.io import from_scipy as _fs

    _S = _sp.random(400, 150, density=0.05, random_state=0, format="csr")
    _S = (_S + _sp.vstack([_sp.eye(150), _sp.csr_matrix((250, 150))])).tocsr()
    _lb = np.random.default_rng(2).standard_normal(400)
    lres = solve(_fs(_S), _lb, method="auto", tol=1e-10, norm="rel_l2")
    _x_ref = _spla.lsmr(_S, _lb, atol=1e-14, btol=1e-14)[0]
    lerr = np.linalg.norm(np.asarray(lres.x) - _x_ref) / np.linalg.norm(_x_ref)
    _r = _lb - _S @ np.asarray(lres.x)
    good = bool(lres.converged) and lerr < 1e-7
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] 400x150 overdetermined, "
        f"method='auto' routes rectangular to LSMR: {int(lres.iterations)} it, "
        f"||A^T r|| {float(np.linalg.norm(_S.T @ _r)):.2e} "
        f"(||r|| {float(np.linalg.norm(_r)):.2f} — inconsistent system), "
        f"rel err vs scipy {lerr:.2e}"
    )

    from conjugategradient_tpu.core.generators import tridiagonal_matrix
    from conjugategradient_tpu.solvers.lobpcg import lobpcg as _lobpcg

    _Ag = generators.poisson2d_matrix(20, 20)
    _Bg = tridiagonal_matrix(_Ag.n, diag=4.0 / 6.0, off=1.0 / 6.0)
    gres = _lobpcg(_Ag, 3, B=_Bg, tol=1e-8, dtype=jnp.float64, max_iterations=500)
    from conjugategradient_tpu.core.formats import dia_to_dense as _d2d

    _wg = _sla.eigh(
        np.asarray(_d2d(_Ag).data), np.asarray(_d2d(_Bg).data), eigvals_only=True
    )[:3]
    gerr2 = float(np.abs(np.asarray(gres.eigenvalues) - _wg).max() / _wg[0])
    good = bool(gres.converged) and gerr2 < 1e-8
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] A x = lam B x (mass-matrix B): "
        f"{int(gres.iterations)} it, eigenvalues match dense eigh(A, B) to "
        f"{gerr2:.1e}"
    )

    # 21. eigs facade + distributed least squares -------------------------
    print("21. eigs facade (Arnoldi/LOBPCG auto-routing); sharded LSMR:")
    from conjugategradient_tpu import eigs as _eigs
    from conjugategradient_tpu.core.generators import (
        convection_diffusion_matrix as _cdm,
        nonsymmetric_banded_matrix as _nbm,
    )

    _CD = _cdm((24, 24), eps=0.1)
    # k=3 cuts cleanly between conjugate pairs (k=4 would split the
    # rank-4/5 pair — either member is then a correct answer)
    er = _eigs(_CD, k=3, which="LM", tol=1e-9)
    _ev = np.linalg.eigvals(np.asarray(_d2d(_CD).data))
    _ref4 = np.sort_complex(_ev[np.argsort(-np.abs(_ev))[:3]])
    eerr = float(np.abs(np.sort_complex(er.values) - _ref4).max())
    n_cplx = int(np.count_nonzero(er.values.imag))
    good = bool(er.converged) and eerr < 1e-7
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] nonsym auto-routes to Krylov-Schur: "
        f"{len(er.values)} pairs ({n_cplx} complex), {er.matvecs} matvecs, "
        f"max err vs dense eig {eerr:.1e}"
    )
    _Ap = generators.poisson2d_matrix(16, 16)
    es = _eigs(_Ap, k=3, which="SM", tol=1e-9, dtype=jnp.float64, max_iterations=400)
    _evs = np.sort(np.linalg.eigvalsh(np.asarray(_d2d(_Ap).data)))[:3]
    serr = float(np.abs(np.sort(es.values.real) - _evs).max())
    good = bool(es.converged) and serr < 1e-6 and es.values.imag.max() == 0.0
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] symmetric SM auto-routes to the "
        f"BLOCK solver (multiplicity-safe): err vs eigvalsh {serr:.1e}"
    )

    from conjugategradient_tpu.parallel.mesh import make_mesh as _mm

    _Az = _nbm(512, 6)
    _bz = np.random.default_rng(5).standard_normal(512)
    lr1 = solve(_Az, _bz, method="lsmr", tol=1e-10, norm="rel_l2", max_iteration=4000)
    lr8 = solve(
        _Az, _bz, method="lsmr", tol=1e-10, norm="rel_l2", max_iteration=4000,
        mesh=_mm(8),
    )
    _rel = float(
        np.linalg.norm(np.asarray(lr8.x) - np.asarray(lr1.x))
        / np.linalg.norm(np.asarray(lr1.x))
    )
    good = bool(lr8.converged) and _rel < 1e-8
    ok &= good
    print(
        f"  [{'OK ' if good else 'BAD'}] LSMR + mesh=: 8-shard solve matches "
        f"single-device to {_rel:.1e} ({int(lr8.iterations)} it)"
    )

    print("ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
