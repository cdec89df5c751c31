"""Scaling sweep: sharded CG / GSPMD MGCG across 1..N mesh devices.

The reference's entire multi-device story is "run on however many GPUs exist"
(SURVEY.md §4.6); this harness is the systematic version: solve the same
(or proportionally grown, ``--weak``) system at every mesh size, validate
against the oracle, and report per-size timings and nnz/s.

On this box the mesh is 8 virtual CPU devices (unless run on a real pod), so
the timings demonstrate the *harness* and the correctness of the sharded
programs — shard-count invariance is the property under test; real scaling
efficiency needs real chips (BASELINE north star: >=80% weak-scaling at
nnz/s on a v5p slice).

Run:  python examples/scaling_sweep.py [--weak] [--base-n 65536]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-n", type=int, default=65536, help="rows per device (weak) or total (strong)")
    ap.add_argument("--band", type=int, default=32)
    ap.add_argument("--weak", action="store_true", help="grow n with the mesh")
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--accelerator", action="store_true",
                    help="use attached accelerators instead of the virtual CPU mesh")
    ap.add_argument("--json", default=None,
                    help="write the sweep as a JSON artifact (default: "
                         "artifacts/scaling_{weak|strong}.json)")
    args = ap.parse_args()

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    # this harness is about the *mesh programs*; by default run on the
    # 8-device virtual CPU mesh (must be selected before backend init)
    if not args.accelerator:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from conjugategradient_tpu import ConvergencePolicy
    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.core.formats import dia_diagonal
    from conjugategradient_tpu.parallel.sharded_cg import make_sharded_cg
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    all_devices = jax.devices()
    sizes = args.devices or [s for s in (1, 2, 4, 8) if s <= len(all_devices)]
    print(f"platform={all_devices[0].platform} devices={len(all_devices)} "
          f"dtype={np.dtype(dtype).name} mode={'weak' if args.weak else 'strong'}")

    from conjugategradient_tpu.parallel.halo import exchange_halos, spmv_dia_local

    def phase_times(data, halo, mesh, offsets, n_local, s):
        """Per-phase microbench: halo exchange, scalar allreduce, and the
        local SpMV, each as its own scan-differenced shard_map program.
        This is the decomposed measurement the >=80% weak-scaling BASELINE
        target needs on real hardware: 'efficiency dropped' is unactionable,
        'halo went from 4% to 31% of the iteration' is a design signal.
        On the virtual CPU mesh the absolute numbers are simulation
        artifacts; the HARNESS (and the fraction arithmetic) is what this
        validates."""
        from functools import partial

        def make(kind):
            def local(data, v, scales):
                def step(w, sc):
                    if kind == "halo":
                        lh, rh = exchange_halos(w, halo, "x", s)
                        w = w * sc + 1e-20 * (lh[0] + rh[-1])
                    elif kind == "allreduce":
                        d = jax.lax.psum(
                            jnp.dot(w[:8], w[:8], preferred_element_type=w.dtype), "x"
                        )
                        w = w * (sc + 1e-20 * d)
                    else:  # local SpMV, no collectives
                        wp = jnp.pad(w, (halo, halo))
                        y = spmv_dia_local(data, offsets, wp, halo)
                        w = y * jax.lax.rsqrt(
                            jnp.dot(y, y, preferred_element_type=y.dtype) / y.size
                            + 1e-30
                        ) * sc
                    return w, w[0]
                w, outs = jax.lax.scan(step, v, scales)
                return outs[-1][None]  # (1,) per shard -> (s,) out

            return jax.jit(
                jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(P(None, "x"), P("x"), P()),
                    out_specs=P("x"),
                )
            )

        rng_l = np.random.default_rng(0)
        out = {}
        for kind in ("halo", "allreduce", "spmv"):
            prog = make(kind)
            times = {}
            for k in (4, 68):
                scales = jnp.asarray(1.0 + rng_l.uniform(1e-6, 1e-5, k).astype(dtype))
                v = jax.device_put(
                    jnp.asarray(rng_l.standard_normal(n_local * s).astype(dtype)),
                    NamedSharding(mesh, P("x")),
                )
                float(prog(data, v, scales)[0])  # compile + warm
                best = float("inf")
                for _ in range(3):
                    scales = jnp.asarray(1.0 + rng_l.uniform(1e-6, 1e-5, k).astype(dtype))
                    t0 = time.perf_counter()
                    float(prog(data, v, scales)[0])
                    best = min(best, time.perf_counter() - t0)
                times[k] = best
            out[kind] = max((times[68] - times[4]) / 64, 1e-12)
        return out

    failures = 0
    base_nnz_per_s = None
    base_phase = None
    rows = []
    for s in sizes:
        n = args.base_n * (s if args.weak else 1)
        system = generators.banded_sin_system(n, args.band, dtype=np.float64)
        mesh = Mesh(np.array(all_devices[:s]), ("x",))
        policy = ConvergencePolicy(tol=1e-8 if dtype == np.float64 else 1e-5,
                                   norm="rel_l2", max_iteration=4 * n)
        solve = make_sharded_cg(system.A, mesh, policy, axis="x",
                                M_local=lambda r, d: d * r, donate=False)
        row = NamedSharding(mesh, P("x"))
        data = jax.device_put(jnp.asarray(system.A.data, dtype=dtype), NamedSharding(mesh, P(None, "x")))
        b = jax.device_put(jnp.asarray(system.b, dtype=dtype), row)
        # zero initial guess so the solver's relative-residual target and the
        # fp64 check below share the same normalisation (||r0|| == ||b||)
        x0 = jax.device_put(jnp.zeros(n, dtype=dtype), row)
        invd = jax.device_put(jnp.asarray(1.0 / dia_diagonal(system.A), dtype=dtype), row)

        res = solve(data, b, x0, invd)
        jax.block_until_ready(res.x)  # compile + warm
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            res = solve(data, b, x0, invd)
        jax.block_until_ready(res.x)
        dt = (time.perf_counter() - t0) / reps

        x = np.asarray(res.x, dtype=np.float64)
        r = system.b - oracle.spmv(system.A, x)
        rel = np.linalg.norm(r) / np.linalg.norm(system.b)
        ok = bool(res.converged) and bool(rel < (1e-7 if dtype == np.float64 else 1e-3))
        failures += 0 if ok else 1
        it = max(int(res.iterations), 1)
        nnz_per_s = system.A.nnz * it / dt
        if base_nnz_per_s is None:
            base_nnz_per_s = nnz_per_s / s  # per-device baseline at the smallest mesh
        # scaling efficiency (the BASELINE north-star metric, >=80% weak):
        # achieved nnz/s throughput vs s * single-device throughput — the
        # same formula for weak (nnz grows with s) and strong (nnz fixed)
        eff = nnz_per_s / (s * base_nnz_per_s) * 100.0
        # per-phase decomposition: the sharded CG iteration is 1 halo
        # exchange + 2 scalar allreduces + the local SpMV (+ axpys); the
        # comm fraction is reported against the measured full iteration.
        # Measured at EVERY mesh size (incl. s=1, where halo/allreduce are
        # degenerate) so the rows can reconcile themselves: on a shared-host
        # virtual mesh the dominant efficiency loss is COMPUTE CONTENTION
        # (s shards timesharing the same cores), which the local-SpMV
        # dilation spmv(s)/spmv(1) measures directly — without it, 22%
        # efficiency with 8% measured comm reads as a design failure when it
        # is a box artifact.
        ph = phase_times(data, system.A.bandwidth, mesh, system.A.offsets,
                         n // s, s)
        t_iter = dt / it
        comm = ph["halo"] + 2.0 * ph["allreduce"] if s > 1 else 0.0
        comm_frac = min(comm / t_iter, 1.0)
        if s == 1 or base_phase is None:
            # first measured size is the contention baseline (identical to
            # the s=1 baseline when the sweep starts at 1; for partial
            # --devices lists the model is relative to the smallest mesh)
            base_phase = {"spmv": ph["spmv"], "t_iter": t_iter}
        contention = ph["spmv"] / base_phase["spmv"]
        # reconciliation model: t_iter(s) ~ contention * t_iter(1) + comm(s)
        t_pred = contention * base_phase["t_iter"] + comm
        recon_err = abs(t_pred - t_iter) / t_iter * 100.0
        print(f"  {s} dev | n={n:>9d} | {it:5d} it | {dt*1e3:9.1f} ms | "
              f"{nnz_per_s/1e9:7.2f} Gnnz/s | eff {eff:6.1f}% | rel res {rel:.1e} | "
              + (f"comm {comm_frac*100:4.1f}% (halo {ph['halo']*1e6:.0f}us "
                 f"ar {ph['allreduce']*1e6:.0f}us spmv {ph['spmv']*1e6:.0f}us) "
                 f"contention {contention:.2f}x recon_err {recon_err:.0f}% | "
                 if s > 1 else "")
              + f"{'OK' if ok else 'MISMATCH'}")
        rows.append({
            "devices": s, "n": n, "nnz": int(system.A.nnz), "iterations": it,
            "time_s": dt, "nnz_per_s": nnz_per_s, "efficiency_pct": eff,
            "rel_residual": float(rel), "ok": ok,
            "local_spmv_us": round(ph["spmv"] * 1e6, 2),
            "iteration_us": round(t_iter * 1e6, 2),
            **({
                "halo_us_per_exchange": round(ph["halo"] * 1e6, 2),
                "allreduce_us": round(ph["allreduce"] * 1e6, 2),
                "comm_fraction_est": round(comm_frac, 4),
                # the box artifact, quantified: local-compute dilation from
                # s shards sharing the host cores (1.0 on real chips)
                "compute_contention": round(contention, 3),
                # what efficiency would be if ONLY comm were lost
                "efficiency_comm_only_pct": round((1.0 - comm_frac) * 100.0, 1),
                # model check: contention * t_iter(1) + comm vs measured
                "iteration_us_predicted": round(t_pred * 1e6, 2),
                "reconciliation_error_pct": round(recon_err, 1),
            } if s > 1 else {}),
        })
    print("ALL OK" if failures == 0 else f"{failures} MISMATCHES")

    import json

    mode = "weak" if args.weak else "strong"
    path = args.json or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "artifacts", f"scaling_{mode}.json"
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "mode": mode,
            "platform": all_devices[0].platform,
            "mesh": "virtual-host" if all_devices[0].platform == "cpu" else "hardware",
            "environment": (
                "VIRTUAL mesh: all devices timeshare one host's cores, so "
                "raw efficiency measures the box, not the design — "
                "compute_contention quantifies that share and "
                "reconciliation_error_pct checks contention*t1+comm against "
                "the measured iteration; read efficiency_comm_only_pct for "
                "the design's own comm cost.  The model reconciles weak "
                "rows to ~10%; strong rows carry larger error because "
                "fixed per-iteration dispatch does not shrink with the "
                "shards (the model omits it)."
                if all_devices[0].platform == "cpu"
                else "hardware mesh"
            ),
            "dtype": np.dtype(dtype).name,
            "band": args.band,
            "metric": "nnz/s (per-iteration SpMV throughput x iterations / wall time)",
            "efficiency_definition": "nnz_per_s / (devices * single-device nnz_per_s) * 100",
            "rows": rows,
        }, f, indent=1)
    print(f"wrote {os.path.normpath(path)}")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
