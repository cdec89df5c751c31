"""End-to-end nonsymmetric demo: convection-diffusion -> BiCGStab / GMRES /
MG-preconditioned -> direct-solve validation.

The workload the reference (CG-only, symmetric fixtures) cannot express:
``-eps * lap(u) + v . grad(u)`` with a recirculating velocity field.  Shows
the method ladder on one operator — plain BiCGStab, plain GMRES(m),
Jacobi-, block-Jacobi- and multigrid-preconditioned — with every solution
validated against the fp64 dense direct solve.

Run:  python examples/nonsym_demo.py --cpu [--side 63] [--eps 0.05]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=63)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--scheme", default="upwind", choices=["upwind", "central"])
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--restart", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from conjugategradient_tpu import solve
    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    on_accelerator = jax.devices()[0].platform != "cpu"
    dtype = np.float32 if (on_accelerator or not jax.config.jax_enable_x64) else np.float64
    tol = max(args.tol, 1e-5) if dtype == np.float32 else args.tol
    grid = (args.side, args.side)

    t0 = time.perf_counter()
    sys_ = generators.convection_diffusion_system(
        grid, eps=args.eps, scheme=args.scheme, dtype=dtype
    )
    build_ms = 1e3 * (time.perf_counter() - t0)
    print(
        f"backend={jax.devices()[0].platform} dtype={np.dtype(dtype).name} "
        f"grid={grid} eps={args.eps} scheme={args.scheme} "
        f"cell-Peclet={1.0 / args.eps:.0f} tol={tol:g} (build {build_ms:.1f} ms)"
    )

    t0 = time.perf_counter()
    x_true = oracle.direct_solve(sys_.A, sys_.b)
    print(f"fp64 dense direct solve: {1e3 * (time.perf_counter() - t0):.1f} ms")

    ladder = [
        ("bicgstab", {}),
        ("gmres", {"restart": args.restart, "max_iteration": 50000}),
        ("idr", {"s": 4, "max_iteration": 50000}),
        ("jacobi_bicgstab", {}),
        ("bjacobi_bicgstab", {"block_size": args.side}),
        ("mg_bicgstab", {"grid": grid}),
        ("mg_gmres", {"grid": grid, "restart": args.restart}),
        ("mg_idr", {"grid": grid}),
    ]
    ok = True
    for method, kw in ladder:
        t0 = time.perf_counter()
        res = solve(
            sys_.A, sys_.b, method=method, tol=tol, norm="rel_l2",
            max_iteration=kw.pop("max_iteration", 20000), **kw,
        )
        np.asarray(res.x)  # block
        ms = 1e3 * (time.perf_counter() - t0)
        err = np.linalg.norm(np.asarray(res.x, np.float64) - x_true) / np.linalg.norm(
            x_true
        )
        limit = 1e-6 if dtype == np.float64 else 1e-2
        good = bool(res.converged) and err < limit
        ok &= good
        print(
            f"[{'OK ' if good else 'BAD'}] {method:<18} {int(res.iterations):>6} it "
            f"{ms:>9.1f} ms   rel err vs direct {err:.2e}"
        )
    print("ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
