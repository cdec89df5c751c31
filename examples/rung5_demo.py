"""Ladder rung 5: ~100M-row Poisson MGCG, assembled shard-by-shard.

Demonstrates the rung-5 data path:

- the fine system is generated *directly into mesh-sharded device arrays*
  (``parallel.rung5.make_rung5_system``) — closed-form slab callbacks, no
  host ever holds the global system;
- the multigrid hierarchy is built by device-side Galerkin probing
  (``precond.distributed.build_hierarchy_probed``) — coarse operators
  computed as sharded GSPMD programs, only O(levels) scalars read back;
- the sharded MGCG solve runs as one GSPMD program with the hierarchy as a
  pytree argument.

Peak-RSS accounting shows host memory stays ~1x the sharded-array footprint
(no 2-3x global staging copy).  Contrast: the reference's multi-GPU driver
slices every shard out of one host-resident global system
(``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:358-379``), capping it
at single-host memory.

Run (virtual 8-device CPU mesh):

    python examples/rung5_demo.py                # 255^3 = 16.6M rows, quick
    python examples/rung5_demo.py --grid 511     # 511^3 = 133M rows (rung 5)
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=255, help="cubic grid extent")
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--tol", type=float, default=1e-5)
    p.add_argument("--max-cg", type=int, default=200)
    args = p.parse_args()

    os.environ.setdefault(
        "XLA_FLAGS", f"--xla_force_host_platform_device_count={args.devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from conjugategradient_tpu.parallel import rung5
    from conjugategradient_tpu.parallel.mesh import make_mesh
    from conjugategradient_tpu.precond.distributed import build_hierarchy_probed
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    mesh = make_mesh()
    grid = (args.grid,) * 3
    n = int(np.prod(grid))
    rss0 = rss_gb()

    t0 = time.perf_counter()
    A, b, x0, padded, n_real = rung5.make_rung5_system(grid, mesh, dtype=np.float32)
    jax.block_until_ready((A.data, b, x0))
    t_asm = time.perf_counter() - t0
    bytes_fine = (A.data.size + b.size + x0.size) * 4
    rss_asm = rss_gb()
    print(
        f"assembled {n:,} rows ({A.nlegs}-leg stencil, padded {padded}) in "
        f"{t_asm:.1f} s | sharded footprint {bytes_fine/1e9:.2f} GB | "
        f"peak RSS {rss0:.2f} -> {rss_asm:.2f} GB"
    )

    t0 = time.perf_counter()
    h = build_hierarchy_probed(A, mesh, max_coarse=1025)
    jax.block_until_ready([l.A.data for l in h.levels])
    t_setup = time.perf_counter() - t0
    rss_setup = rss_gb()
    print(
        f"probed hierarchy: {len(h.levels)}+1 levels "
        f"{[l.grid for l in h.levels]} in {t_setup:.1f} s | peak RSS {rss_setup:.2f} GB"
    )

    pol = ConvergencePolicy(tol=args.tol, norm="rel_l2", max_iteration=args.max_cg)
    solve = rung5.make_rung5_mgcg(pol, h)
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve(b, x0))
    t_solve = time.perf_counter() - t0
    rss_end = rss_gb()
    print(
        f"MGCG: {int(res.iterations)} its, rel residual {float(res.residual):.3e}, "
        f"converged={bool(res.converged)} in {t_solve:.1f} s | peak RSS {rss_end:.2f} GB"
    )

    summary = {
        "rows": n,
        "grid": list(grid),
        "devices": args.devices,
        "assembly_s": round(t_asm, 2),
        "setup_s": round(t_setup, 2),
        "solve_s": round(t_solve, 2),
        "iterations": int(res.iterations),
        "rel_residual": float(res.residual),
        "converged": bool(res.converged),
        "sharded_footprint_gb": round(bytes_fine / 1e9, 3),
        "peak_rss_gb": round(rss_end, 2),
        "mesh": "virtual-cpu",
    }
    print(json.dumps(summary))
    return 0 if res.converged else 1


if __name__ == "__main__":
    raise SystemExit(main())
