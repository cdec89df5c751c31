"""Multigrid-preconditioned CG demo: the solver the reference's name promised.

Builds a Poisson system (the BASELINE.json config-ladder workload family),
solves it three ways — CPU oracle CG, device plain CG, device MGCG — and
differential-validates, reporting the iteration-count collapse multigrid buys.

Run:  python examples/mgcg_demo.py [--grid 255 255] [--smoother chebyshev]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, nargs="+", default=[255, 255])
    ap.add_argument("--smoother", default="chebyshev", choices=["jacobi", "chebyshev"])
    ap.add_argument("--pre", type=int, default=2)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument(
        "--spectrum",
        action="store_true",
        help="estimate kappa(A) and kappa(M^-1 A) from the solves' own CG "
        "coefficients (the R prototype's commented kappa probe, R/CG.R:26-27)",
    )
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_ENABLE_X64"] = "true"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from conjugategradient_tpu import ConvergencePolicy, cg_solve
    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.precond import build_hierarchy
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    on_accelerator = jax.devices()[0].platform != "cpu"
    dtype = np.float32 if (on_accelerator or not jax.config.jax_enable_x64) else np.float64
    norm, tol = ("l2", args.tol) if dtype == np.float64 else ("rel_l2", max(args.tol, 1e-5))

    grid = tuple(args.grid)
    system = generators.poisson_system(grid)
    n = system.n
    print(f"backend={jax.devices()[0].platform} dtype={np.dtype(dtype).name} "
          f"grid={grid} n={n} smoother={args.smoother} norm={norm} tol={tol:g}")

    # CPU oracle (fp64) ground truth.
    t0 = time.perf_counter()
    ref = oracle.cg(system.A, system.b, tol=args.tol, norm="l2", max_iteration=4 * n)
    t_oracle = time.perf_counter() - t0

    policy = ConvergencePolicy(tol=tol, norm=norm, max_iteration=4 * n)
    A = system.A.device_put(dtype=dtype)
    b = jnp.asarray(system.b, dtype=dtype)

    # Plain CG.  A and (below) the hierarchy ride as pytree ARGUMENTS, not
    # closure constants (closure constants are baked into the compiled
    # program — hundreds of MB at 16M rows).
    plain_solve = jax.jit(lambda A_, b: cg_solve(A_, b, policy=policy))
    jax.block_until_ready(plain_solve(A, b).x)
    t0 = time.perf_counter()
    plain = plain_solve(A, b)
    jax.block_until_ready(plain.x)
    t_plain = time.perf_counter() - t0

    # MGCG: hierarchy setup (host, once) + jitted PCG with a V-cycle as M.
    t0 = time.perf_counter()
    h = build_hierarchy(system.A, grid, smoother=args.smoother, pre=args.pre,
                        post=args.pre, dtype=dtype)
    t_setup = time.perf_counter() - t0
    from conjugategradient_tpu.precond.multigrid import v_cycle

    mg_solve = jax.jit(
        lambda A_, h_, b: cg_solve(A_, b, policy=policy, M=(v_cycle, h_))
    )
    jax.block_until_ready(mg_solve(A, h, b).x)
    t0 = time.perf_counter()
    mg = mg_solve(A, h, b)
    jax.block_until_ready(mg.x)
    t_mg = time.perf_counter() - t0

    x_mg = np.asarray(mg.x, dtype=np.float64)
    # mixed abs/rel denominator: pointwise relative error is meaningless where
    # the solution passes through zero, so floor at 1e-3 * ||x||_inf.
    denom = np.maximum(np.abs(ref.x), 1e-3 * np.max(np.abs(ref.x)))
    rel_err = np.max(np.abs(x_mg - ref.x) / denom)
    # fp64 true residual — solution-space rel-err between two tol-converged
    # solves is bounded only by kappa*tol, so the residual is the real check.
    true_res = np.linalg.norm(system.b - oracle.spmv(system.A, x_mg))

    print(f"oracle   {t_oracle*1e3:9.1f} ms  {ref.iterations:5d} it")
    print(f"plain CG {t_plain*1e3:9.1f} ms  {int(plain.iterations):5d} it   "
          f"residual {float(plain.residual):.3e}")
    print(f"MGCG     {t_mg*1e3:9.1f} ms  {int(mg.iterations):5d} it   "
          f"residual {float(mg.residual):.3e}   (+ setup {t_setup*1e3:.1f} ms, "
          f"{len(h.levels)}+1 levels)")
    print(f"true fp64 residual {true_res:.3e} | max elementwise rel err vs oracle "
          f"{rel_err:.3e} | iteration reduction {int(plain.iterations)}/"
          f"{int(mg.iterations)} = {int(plain.iterations)/max(int(mg.iterations),1):.1f}x")

    if args.spectrum:
        # zero extra matrix passes: the Ritz values fall out of the traced
        # solves' own recurrence scalars (solvers.eigen.spectrum_from_cg)
        from conjugategradient_tpu.solvers.cg import cg_solve_traced
        from conjugategradient_tpu.solvers.eigen import spectrum_from_cg

        for label, use_mg in (("A", False), ("M^-1 A", True)):
            steps = int((mg if use_mg else plain).iterations) + 1
            # matrix + hierarchy as pytree arguments (see note above)
            traced = jax.jit(
                lambda A_, h_, b, use_mg=use_mg, steps=steps: cg_solve_traced(
                    A_, b, policy=policy, M=(v_cycle, h_) if use_mg else None,
                    num_steps=steps, with_coefficients=True,
                )
            )
            tres, _, (al, be) = traced(A, h, b)
            lo, hi, kappa = spectrum_from_cg(al, be, int(tres.iterations))
            print(f"spectrum({label}): lam in [{lo:.4e}, {hi:.4e}]  kappa ~ {kappa:.1f}")

    ok = (
        bool(mg.converged)
        and true_res < 100 * tol  # fp64 recomputation of the device residual
        and rel_err < 1e-2  # the reference drivers' own 1% rule (MgcgMain.cs:129-140)
        and int(mg.iterations) * 2 <= int(plain.iterations)
    )
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
