"""End-to-end single-device demo: generator -> device CG -> oracle validation.

The device-resident rebirth of the reference's standalone demo
(``SimpleConjugateGradient/SimpleConjugateGradient.cu:128-254``) and of the
cuBlas driver's differential-validation flow
(``Mgcg/cuBlas/Mgcg/MgcgMain.cs:41-178``): build a deterministic SPD system,
solve with the CPU oracle, solve on-device, compare element-wise, report
iterations / residual / phase timings.

Run:  python examples/solve_demo.py [--n 65536] [--workload tridiag|banded|poisson2d]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--workload", default="tridiag", choices=["tridiag", "banded", "poisson2d"])
    ap.add_argument("--band", type=int, default=160)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--norm", default="l2", choices=["l2", "linf", "rel_l2"])
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
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
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    on_accelerator = jax.devices()[0].platform != "cpu"
    dtype = np.float32 if (on_accelerator or not jax.config.jax_enable_x64) else np.float64
    # fp32 storage cannot hit the reference's absolute 1e-8 against large ‖b‖;
    # switch to the ViennaCL relative-residual convention there.
    norm, tol = (args.norm, args.tol) if dtype == np.float64 else ("rel_l2", max(args.tol, 1e-5))

    print(f"backend={jax.devices()[0].platform} dtype={np.dtype(dtype).name} N={args.n} "
          f"norm={norm} tol={tol:g}")

    t0 = time.perf_counter()
    if args.workload == "tridiag":
        system = generators.tridiagonal_system(args.n)
    elif args.workload == "banded":
        system = generators.banded_sin_system(args.n, args.band)
    else:
        side = int(np.sqrt(args.n))
        system = generators.poisson_system((side, side))
    t_build = time.perf_counter() - t0

    # CPU oracle (fp64 numpy) — the reference's differential ground truth.
    t0 = time.perf_counter()
    ref = oracle.cg(system.A, system.b, system.x0, tol=args.tol, norm=args.norm,
                    max_iteration=4 * system.n)
    t_oracle = time.perf_counter() - t0

    # Device solve: one jitted program, loop fully on-device.  Grid-structured
    # workloads route through the StencilMatrix roofline path (ops/stencil.py).
    policy = ConvergencePolicy(tol=tol, norm=norm, max_iteration=4 * system.n)
    if args.workload == "poisson2d":
        from conjugategradient_tpu.core.formats import dia_to_stencil

        shape = (side, side)
        A = dia_to_stencil(system.A, shape).device_put(dtype=dtype)
    else:
        shape = (system.n,)
        A = system.A.device_put(dtype=dtype)
    b = jnp.asarray(system.b, dtype=dtype).reshape(shape)
    x0 = jnp.asarray(system.x0, dtype=dtype).reshape(shape)
    solve = jax.jit(lambda b, x0: cg_solve(A, b, x0, policy, precise_dot=(dtype == np.float32)))

    t0 = time.perf_counter()
    res = solve(b, x0)
    jax.block_until_ready(res.x)
    t_compile_and_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve(b, x0)
    jax.block_until_ready(res.x)
    t_solve = time.perf_counter() - t0

    # Element-wise validation vs the oracle (MgcgMain.cs:129-140 discipline).
    x_dev = np.asarray(res.x, dtype=np.float64).reshape(-1)
    denom = np.maximum(np.abs(ref.x), 1e-30)
    rel_err = np.max(np.abs(x_dev - ref.x) / denom)
    it_dev, it_ref = int(res.iterations), ref.iterations

    nnz = system.A.nnz
    gflops = 2.0 * nnz * max(it_dev, 1) / max(t_solve, 1e-12) / 1e9
    print(f"build {t_build*1e3:8.1f} ms | oracle {t_oracle*1e3:8.1f} ms "
          f"({it_ref} it) | device first {t_compile_and_first*1e3:8.1f} ms | "
          f"device steady {t_solve*1e3:8.1f} ms ({it_dev} it, "
          f"{t_solve/max(it_dev,1)*1e6:.1f} us/it, {gflops:.1f} SpMV-GFLOP/s)")
    print(f"device residual {float(res.residual):.3e} converged={bool(res.converged)} | "
          f"max elementwise rel err vs oracle {rel_err:.3e}")

    ok = bool(res.converged) and rel_err < (1e-2 if dtype == np.float32 else 1e-6)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
