"""Real multi-process distributed solve: N OS processes, one global mesh.

A multi-host story needs more than helpers plus a single-process
degradation test.  This driver launches N
*separate interpreter processes*, each of which

- joins the JAX process group (``multihost.initialize_distributed`` with an
  explicit coordinator — the real `jax.distributed.initialize` contract used
  on multi-host clusters, here over the CPU Gloo collectives backend);
- builds the global 1-D mesh over all ``N x local_devices`` global devices
  (``multihost.global_mesh``);
- assembles the workload straight into mesh-sharded arrays via the
  per-row-block callbacks (``multihost.make_distributed_system``) — each
  process generates ONLY its addressable row slabs, exactly the rung-5
  contract;
- runs one GSPMD CG solve spanning every process (the in-program reduction
  collectives cross the process boundary over Gloo — the re-design of the
  reference's host-threaded multi-GPU orchestration,
  ``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:424-565``, at the
  deployment scale the reference never reached);
- validates its OWN addressable shards element-wise against the fp64 numpy
  oracle (no global gather — the multi-host-safe validation pattern).

With ``--mgcg`` it additionally runs the rung-5 path end-to-end across
processes: sharded stencil assembly + device-side probed Galerkin hierarchy
(``precond.distributed.build_hierarchy_probed``) + sharded MGCG.

Usage (this box: CPU backend, 2 processes x 4 local devices):

    python examples/multiprocess_demo.py                 # launcher, CG
    python examples/multiprocess_demo.py --mgcg          # + probed MGCG
    python examples/multiprocess_demo.py --procs 4 --local-devices 2

The launcher exits 0 iff every worker validated OK.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------


def worker(args) -> int:
    import jax  # noqa: E402  (platform must be pinned before any backend query)

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import numpy as np

    from conjugategradient_tpu.parallel import multihost

    multihost.initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.procs,
        process_id=args.process_id,
        strict=True,
    )
    pid = jax.process_index()
    nproc = jax.process_count()
    ndev = len(jax.devices())
    assert nproc == args.procs, (nproc, args.procs)
    log = lambda msg: print(f"[proc {pid}/{nproc}] {msg}", flush=True)
    log(f"joined: {ndev} global devices, {len(jax.local_devices())} local")

    mesh = multihost.global_mesh()
    ok = _run_cg(args, mesh, pid, log)
    if args.mgcg:
        ok = _run_mgcg(args, mesh, pid, log) and ok

    # A final cross-process barrier so no process tears down the Gloo context
    # while a peer is still inside a collective.
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("multiprocess_demo_done")
    return 0 if ok else 1


def _shards_match(x, ref, tol, log) -> bool:
    """Validate only this process's addressable shards against the global
    fp64 reference — the pattern that stays host-memory-bounded on a pod."""
    import numpy as np

    worst = 0.0
    for sh in x.addressable_shards:
        got = np.asarray(sh.data)
        want = ref[sh.index]
        denom = max(1e-30, float(np.max(np.abs(want))) if want.size else 1.0)
        if want.size:
            worst = max(worst, float(np.max(np.abs(got - want))) / denom)
    log(f"local-shard validation: worst rel err {worst:.3e} (tol {tol:g})")
    return worst < tol


def _run_cg(args, mesh, pid, log) -> bool:
    import jax
    import numpy as np

    from conjugategradient_tpu.core import oracle
    from conjugategradient_tpu.models import get
    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.parallel import multihost
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    policy = ConvergencePolicy(tol=1e-9, norm="rel_l2", max_iteration=20000)
    t0 = time.perf_counter()
    A, b, x0, n = multihost.make_distributed_system(args.workload, mesh, dtype=np.float64)
    jax.block_until_ready((A.data, b, x0))
    log(
        f"assembled '{args.workload}' n={n:,} (padded {b.shape[0]:,}) "
        f"in {time.perf_counter() - t0:.2f} s, sharded over {len(jax.devices())} devices"
    )

    # roll=True: the GSPMD-friendly DIA formulation (static rolls lower to
    # collective-permutes on the sharded axis; cf. parallel.rung5.make_rung5_cg)
    solve = jax.jit(lambda A, b, x0: cg_solve(as_operator(A, roll=True), b, x0, policy=policy))
    t0 = time.perf_counter()
    res = solve(A, b, x0)
    jax.block_until_ready(res.x)
    it = int(res.iterations)
    log(
        f"GSPMD CG across processes: {it} iterations, residual "
        f"{float(res.residual):.3e}, converged={bool(res.converged)}, "
        f"{time.perf_counter() - t0:.2f} s"
    )
    if not bool(res.converged):
        log("FAIL: did not converge")
        return False

    # Every process derives the same fp64 reference from the closed-form
    # generators (cheap at demo sizes), then checks only its own shards.
    w = get(args.workload)
    sys_full = w.build(dtype=np.float64)
    ores = oracle.cg(
        sys_full.A,
        np.asarray(sys_full.b),
        np.asarray(sys_full.x0),
        tol=1e-11,
        max_iteration=20000,
        norm="rel_l2",
    )
    ref = np.zeros(b.shape[0])
    ref[:n] = ores.x
    ok = _shards_match(res.x, ref, 1e-6, log)
    log("CG OK" if ok else "CG MISMATCH")
    return ok


def _run_mgcg(args, mesh, pid, log) -> bool:
    import jax
    import numpy as np

    from conjugategradient_tpu.parallel import rung5
    from conjugategradient_tpu.precond.distributed import build_hierarchy_probed
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    grid = (args.grid,) * 3
    n = int(np.prod(grid))
    t0 = time.perf_counter()
    A, b, x0, padded, n_real = rung5.make_rung5_system(grid, mesh, dtype=np.float32)
    jax.block_until_ready((A.data, b, x0))
    log(f"rung5 stencil {grid} = {n:,} rows assembled in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    h = build_hierarchy_probed(A, mesh, max_coarse=1025)
    log(
        f"probed hierarchy: {len(h.levels)} levels in {time.perf_counter() - t0:.1f} s "
        f"(cross-process Galerkin probing)"
    )

    policy = ConvergencePolicy(tol=1e-5, norm="rel_l2", max_iteration=200)
    solve = rung5.make_rung5_mgcg(policy, h)
    t0 = time.perf_counter()
    res = solve(b, x0)
    jax.block_until_ready(res.x)
    log(
        f"sharded MGCG: {int(res.iterations)} iterations, residual "
        f"{float(res.residual):.3e}, converged={bool(res.converged)}, "
        f"{time.perf_counter() - t0:.1f} s"
    )
    ok = bool(res.converged)
    log("MGCG OK" if ok else "MGCG FAIL (not converged)")
    return ok


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args) -> int:
    port = free_port()
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for i in range(args.procs):
        env = dict(os.environ)
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.local_devices} "
            + env.get("XLA_FLAGS", "").replace(
                "--xla_force_host_platform_device_count=8", ""
            )
        ).strip()
        env.pop("JAX_NUM_PROCESSES", None)
        cmd = [
            sys.executable,
            os.path.abspath(__file__),
            "--worker",
            "--coordinator",
            coordinator,
            "--process-id",
            str(i),
            "--procs",
            str(args.procs),
            "--workload",
            args.workload,
            "--grid",
            str(args.grid),
        ] + (["--mgcg"] if args.mgcg else [])
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO))
    deadline = time.time() + args.timeout
    rc = 0
    for i, p in enumerate(procs):
        try:
            r = p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            r = -9
            print(f"launcher: worker {i} TIMED OUT after {args.timeout}s")
        rc = rc or r
    verdict = "OK" if rc == 0 else "MISMATCH"
    print(
        json.dumps(
            {
                "demo": "multiprocess",
                "processes": args.procs,
                "local_devices": args.local_devices,
                "global_devices": args.procs * args.local_devices,
                "workload": args.workload,
                "mgcg": bool(args.mgcg),
                "verdict": verdict,
            }
        )
    )
    return rc


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true", help="internal: run as a worker process")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--workload", default="viennacl_large")
    p.add_argument("--mgcg", action="store_true", help="also run the rung-5 probed-MGCG path")
    p.add_argument("--grid", type=int, default=31, help="cubic grid extent for --mgcg")
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args()
    return worker(args) if args.worker else launch(args)


if __name__ == "__main__":
    sys.exit(main())
