"""Headline benchmark: MGCG time-to-solution on the ~1M-row 2-D Poisson
ladder workload (BASELINE.json configs[2]), one GPU.

    python bench.py

Prints JSON lines; each line is the FULL record so far, so the *last*
complete line is always the most complete result and the *first* line
already carries the headline:
  {"metric": ..., "value": <MGCG steady-state solve seconds>, "unit": "s",
   "vs_baseline": <plain-CG time / MGCG time>, ...extras...}

``vs_baseline`` is the speedup over plain (unpreconditioned) CG on the same
card and kernels — plain CG being what the reference actually implements
(its "Mgcg" name notwithstanding, SURVEY.md §0), this is the direct
capability-times-performance ratio against the reference design.  ``value``
tracks absolute solver performance.  Every record names the device
(platform, device kind, count) and the card's power limit.

Robustness:
  1. The headline MGCG number prints IMMEDIATELY after its two scan pairs
     complete; everything after is additive.
  2. Every extra section runs under a wall-clock budget
     (``BENCH_DEADLINE_S``, default 1080 s) and is skipped — with the skip
     recorded — when the remaining budget is below its floor.
  3. A failing section (the canary included) is recorded in
     ``sections_failed`` and the record re-prints either way; the process
     then exits nonzero.  A section skipped for budget is recorded in
     ``sections_skipped`` and is not a failure.

Measurement: the repetition lives *inside* one compiled program — a
``lax.scan`` chains K full solves (each consuming the previous solution, so
nothing can be elided), and two scan lengths are differenced to cancel the
fixed dispatch/readback overhead exactly.

Self-verification:
  1. A CANARY runs before anything else and lands in the record: measured
     copy and read-reduce GB/s of this card in this run.
  2. The headline is measured as TWO independent scan pairs (fresh scales);
     they must agree within 15% or a third pair runs and the record carries
     ``headline_unstable: true``.  The reported value is the median of all
     pairs; every pair's differenced value AND the raw per-try chain times
     for both scan lengths are in the record.
  3. Every SpMV row carries ``implied_gb_s`` (minimum stored-stream bytes /
     time) and ``share_of_copy`` against the same-run canary copy rate.

fp32 storage + compensated dots, relative-L2 tolerance 1e-6 (fp32's
attainable floor; the reference's absolute 1e-8 is an fp64 number — see
``solvers/refine.py`` for meeting it via iterative refinement).  There is no
CPU fallback: without a GPU the run exits nonzero.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

_T0 = time.monotonic()
_DEADLINE_S = float(os.environ.get("BENCH_DEADLINE_S", "1080"))


def _remaining() -> float:
    return _DEADLINE_S - (time.monotonic() - _T0)


def main() -> None:
    import sys

    from conjugategradient_tpu.utils.runtime import (
        NoGPUError,
        card_info,
        require_gpu,
        setup_compile_cache,
    )

    setup_compile_cache()
    try:
        devices = require_gpu()
    except NoGPUError as e:
        print(json.dumps({"metric": "mgcg_1M_poisson_solve", "value": None,
                          "unit": "s", "vs_baseline": None, "error": str(e)}),
              flush=True)
        sys.exit(1)
    import jax
    import jax.numpy as jnp

    dev0 = devices[0]
    platform = dev0.platform
    device = {"platform": platform, "device_kind": dev0.device_kind,
              "count": len(devices), "card": card_info()}

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.core.formats import dia_to_stencil
    from conjugategradient_tpu.precond import as_preconditioner, build_hierarchy
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    grid = (1023, 1023)
    dtype = np.float32
    tol = 1e-6
    # spread sizing: each differenced chain carries ~0.3-1.5 s of solves,
    # far above the per-call dispatch/readback jitter it cancels
    k_pair_plain = (2, 82)
    k_pair_mg = (2, 1202)
    n_tries = 5

    system = generators.poisson_system(grid, dtype=dtype)
    n = system.n
    policy = ConvergencePolicy(tol=tol, norm="rel_l2", max_iteration=8 * n)
    A = dia_to_stencil(system.A, grid).device_put(dtype=dtype)
    b = jnp.asarray(system.b, dtype=dtype).reshape(grid)
    rng = np.random.default_rng()

    def make_scan(with_mg: bool, policy=policy):
        """One jitted program running scales.shape[0] chained full solves."""

        def run(h, A, b, scales):
            M = as_preconditioner(h) if with_mg else None

            def step(prev_x, s):
                res = cg_solve(
                    A, b * s + 1e-30 * prev_x, policy=policy, M=M, precise_dot=True
                )
                return res.x, (res.iterations, res.residual, res.converged)

            x, (its, ress, convs) = jax.lax.scan(step, jnp.zeros_like(b), scales)
            return x, its, ress, convs

        return jax.jit(run)

    def timed(run, h, A, b, K_pair, tries: int = 3, dtype=dtype):
        """Difference two scan lengths (min over ``tries`` to cut round-trip
        noise); scales drawn fresh each call (anti-memoization).  Returns the
        per-solve time, the last chain's aux outputs, and the RAW per-try
        chain wall times for both lengths (banked in the record so a bad
        differenced value is diagnosable after the fact)."""
        k1, k2 = K_pair
        times = {}
        raw = {}
        out = None
        for k in (k1, k2):
            scales = jnp.asarray(1.0 + rng.uniform(1e-5, 1e-3, k).astype(dtype))
            x, its, ress, convs = run(h, A, b, scales)
            float(ress[-1])  # force the warm chain too
            raw[k] = []
            for _ in range(tries):
                scales = jnp.asarray(1.0 + rng.uniform(1e-5, 1e-3, k).astype(dtype))
                t0 = time.perf_counter()
                x, its, ress, convs = run(h, A, b, scales)
                float(ress[-1])  # scalar readback forces the whole chain
                raw[k].append(time.perf_counter() - t0)
            times[k] = min(raw[k])
            out = (its, ress, convs)
        per_solve = (times[k2] - times[k1]) / (k2 - k1)
        return max(per_solve, 1e-9), out, raw

    def timed_verified(run, h, A, b, K_pair, tries: int = 3, dtype=dtype,
                       rel_gate: float = 0.15):
        """The self-verifying headline protocol: TWO independent scan pairs
        must agree within ``rel_gate`` of the smaller; on disagreement a
        THIRD pair runs and ``unstable`` is flagged.  Reported value =
        median of all pairs (one silent pair cannot be arbitrated from the
        record alone)."""
        vals, raws = [], []
        out = None
        for _ in range(2):
            t, out, raw = timed(run, h, A, b, K_pair, tries=tries, dtype=dtype)
            vals.append(t)
            raws.append(raw)
        unstable = abs(vals[0] - vals[1]) > rel_gate * min(vals)
        if unstable:
            t, out, raw = timed(run, h, A, b, K_pair, tries=tries, dtype=dtype)
            vals.append(t)
            raws.append(raw)
        value = float(np.median(vals))
        protocol = {
            "pairs_s": [round(v, 7) for v in vals],
            "raw_chain_s": [
                {str(k): [round(t, 5) for t in ts] for k, ts in raw.items()}
                for raw in raws
            ],
            "unstable": bool(unstable),
        }
        return value, out, protocol

    # ------------------------------------------------------------------
    # Section 0 (canary — runs FIRST, lands in every record): measured copy
    # and read-reduce GB/s of this card in this run.  These arbitrate every
    # other number in the record: a headline 3x slower with identical
    # canaries is a protocol/measurement problem, not card drift.
    # ------------------------------------------------------------------
    from conjugategradient_tpu.utils.timers import copy_rate_gb_s, per_step_seconds

    canary = {}
    try:
        m = 64 * 1024 * 1024
        canary["copy_gb_s"] = round(copy_rate_gb_s(m, ks=(4, 404), tries=5), 1)
        xc = jax.random.normal(jax.random.PRNGKey(0), (m,), dtype=jnp.float32)
        # max(x, c-dependent scalar): nonlinear in x, so the sum cannot be
        # hoisted out of the chain; one full read per step, no write
        t_read = per_step_seconds(
            lambda c, x: jnp.sum(jnp.maximum(x, 0.5 + 1e-30 * c)),
            jnp.float32(0.0), xc, ks=(4, 404), tries=5)
        canary["read_reduce_gb_s"] = round(4 * m / t_read / 1e9, 1)
        del xc
    except Exception as e:  # noqa: BLE001 — recorded, and the run exits nonzero
        canary["error"] = f"{type(e).__name__}: {e}"[:200]
    # the denominator of every SpMV row's share below: this run's copy rate
    # (None when the canary failed; the rows then carry no share)
    _copy_gb_s = canary.get("copy_gb_s")

    # ------------------------------------------------------------------
    # Section 1 (headline — prints before anything else can fail): MGCG vs
    # plain CG on the 1023^2 (1,046,529-row) Poisson system.
    # ------------------------------------------------------------------
    # cycle shape: rediscretized 5-point const-stencil levels + cheb(2,2)
    # (Galerkin coarse stencils carry 9 legs; redisc keeps 5, and the
    # coarse-level chain is latency-bound).  Poisson redisc == Galerkin
    # convergence class (test_redisc); setup is generator-time.
    h = build_hierarchy(
        system.A, grid, smoother="chebyshev", pre=2, post=2, dtype=dtype,
        coarse_operator=generators.poisson_coarse_operator(dtype),
    )
    # the hierarchy's fine operator is const-detected (the Dirichlet
    # Laplacian has constant coefficients): zero matrix bytes per SpMV.
    # BOTH runs use it — plain CG gets the same upgrade, so vs_baseline
    # stays an algorithm comparison, not an operator trick.
    A_var = A  # variable-coefficient stencil (the BASELINE SpMV metric)
    if h.levels:
        A = h.levels[0].A

    plain_run = make_scan(with_mg=False)
    t_plain, (p_its, p_ress, p_convs), plain_proto = timed_verified(
        plain_run, h, A, b, k_pair_plain, tries=n_tries
    )

    mg_run = make_scan(with_mg=True)
    t_mg, (m_its, m_ress, m_convs), mg_proto = timed_verified(
        mg_run, h, A, b, k_pair_mg, tries=n_tries
    )

    assert bool(np.asarray(m_convs).all()), f"MGCG failed: residuals {np.asarray(m_ress)}"

    record = {
        "metric": f"mgcg_poisson2d_{n}_time",
        "value": round(t_mg, 6),
        "unit": "s",
        "vs_baseline": round(t_plain / t_mg, 3),
        "platform": platform,
        "device": device,
        "n": n,
        "mgcg_iters": int(np.asarray(m_its)[-1]),
        "plain_cg_iters": int(np.asarray(p_its)[-1]),
        "plain_cg_s": round(t_plain, 6),
        "headline_unstable": bool(mg_proto["unstable"] or plain_proto["unstable"]),
        "headline_protocol": {"mgcg": mg_proto, "plain_cg": plain_proto},
        "canary": canary,
        "sections_skipped": {},
        "sections_failed": {"canary": canary["error"]} if "error" in canary else {},
    }
    print(json.dumps(record), flush=True)

    record["section_wall_s"] = {}

    def section(name: str, floor_s: float):
        """Decorator-ish runner: executes fn under budget, records skips,
        failures and per-section wall time, re-prints the cumulative record
        either way."""

        def run(fn):
            rem = _remaining()
            if rem < floor_s:
                record["sections_skipped"][name] = f"budget: {rem:.0f}s left < {floor_s:.0f}s floor"
            else:
                t0 = time.monotonic()
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — a lost section must not lose the record
                    record["sections_failed"][name] = f"{type(e).__name__}: {e}"[:300]
                record["section_wall_s"][name] = round(time.monotonic() - t0, 1)
            print(json.dumps(record), flush=True)

        return run

    # ------------------------------------------------------------------
    # Section 2: the 3-D ladder rung (BASELINE configs[3]) — 255^3 =
    # 16,581,375 rows, rediscretized const-stencil hierarchy (setup is
    # generator-time; every level streams zero matrix bytes).
    # ------------------------------------------------------------------
    @section("mgcg_poisson3d", floor_s=300.0)
    def _poisson3d():
        g3 = (255, 255, 255)
        sys3 = generators.poisson_system(g3, dtype=dtype)
        t0 = time.perf_counter()
        h3 = build_hierarchy(
            sys3.A, g3, smoother="chebyshev", pre=2, post=2, dtype=dtype,
            coarse_operator=generators.poisson_coarse_operator(dtype),
        )
        setup_s = time.perf_counter() - t0
        A3 = h3.levels[0].A
        b3 = jnp.asarray(sys3.b, dtype=dtype).reshape(g3)
        pol3 = ConvergencePolicy(tol=tol, norm="rel_l2", max_iteration=8 * sys3.n)
        run3 = make_scan(with_mg=True, policy=pol3)
        # raw chain times ride in the record regardless
        t3, (i3, r3, c3), proto3 = timed(run3, h3, A3, b3, (1, 13))
        assert bool(np.asarray(c3).all()), f"3-D MGCG failed: {np.asarray(r3)}"
        record["mgcg_poisson3d"] = {
            "n": sys3.n,
            "grid": list(g3),
            "solve_s": round(t3, 5),
            "iters": int(np.asarray(i3)[-1]),
            "setup_s": round(setup_s, 1),
            "levels": f"{len(h3.levels)}+1",
            "tol": tol,
            "raw_chain_s": {str(k): [round(t, 4) for t in ts]
                            for k, ts in proto3.items()},
        }

    # ------------------------------------------------------------------
    # Section 2b: the 100M-row ladder extension — 511^3 = 133.4M rows on
    # ONE card (the const-stencil hierarchy ships zero matrix bytes, so the
    # operator costs nothing in device memory; setup is host-side).
    # ------------------------------------------------------------------
    @section("mgcg_poisson3d_511", floor_s=420.0)
    def _poisson3d_511():
        g5 = (511, 511, 511)
        sys5 = generators.poisson_system(g5, dtype=dtype)
        t0 = time.perf_counter()
        h5 = build_hierarchy(
            sys5.A, g5, smoother="chebyshev", pre=2, post=2, dtype=dtype,
            coarse_operator=generators.poisson_coarse_operator(dtype),
        )
        setup_s = time.perf_counter() - t0
        A5 = h5.levels[0].A
        b5 = jnp.asarray(sys5.b, dtype=dtype).reshape(g5)
        pol5 = ConvergencePolicy(tol=tol, norm="rel_l2", max_iteration=8 * sys5.n)
        run5 = make_scan(with_mg=True, policy=pol5)
        t5, (i5, r5, c5), proto5 = timed(run5, h5, A5, b5, (1, 3), tries=2)
        assert bool(np.asarray(c5).all()), f"511^3 MGCG failed: {np.asarray(r5)}"
        record["mgcg_poisson3d_511"] = {
            "n": sys5.n,
            "solve_s": round(t5, 4),
            "iters": int(np.asarray(i5)[-1]),
            "setup_s": round(setup_s, 1),
            "levels": f"{len(h5.levels)}+1",
            "tol": tol,
            "raw_chain_s": {str(k): [round(t, 3) for t in ts]
                            for k, ts in proto5.items()},
        }

    # ------------------------------------------------------------------
    # Section 3: per-card SpMV metrics (BASELINE.md declared targets:
    # GFLOP/s + nnz/s for the stencil path AND the flat band-160 DIA path).
    # ------------------------------------------------------------------
    from conjugategradient_tpu.core import oracle
    from conjugategradient_tpu.ops.precision import MATMUL_PRECISION
    from conjugategradient_tpu.ops.spmv import as_operator

    def spmv_timed(op, A_arg, v0, k_pair, tries=5):
        """Per-SpMV device time: each step applies the operator and
        rescales to unit RMS (the chain stays bounded on any matrix)."""
        def step(w, Ad):
            y = op(Ad, w)
            return y * jax.lax.rsqrt(
                jnp.vdot(y, y, precision=MATMUL_PRECISION) / y.size + 1e-30)

        return per_step_seconds(step, v0, A_arg, ks=k_pair, tries=tries)

    k_spmv = (16, 4112)

    def spmv_rate(stream_bytes: float, t_s: float) -> dict:
        """Implied traffic rate (``stream_bytes``: the minimum per-op stream,
        matrix coefficients + x read + y write) and its share of the
        same-run canary copy rate."""
        implied = stream_bytes / t_s / 1e9
        row = {"implied_gb_s": round(implied, 1),
               "stream_mb": round(stream_bytes / 1e6, 1)}
        if _copy_gb_s:
            row["share_of_copy"] = round(implied / _copy_gb_s, 3)
        return row

    @section("spmv_stencil", floor_s=120.0)
    def _spmv_stencil():
        # stencil path: the fine operator of the headline workload — measured
        # on the VARIABLE-coefficient form (the BASELINE metric; the
        # const-detected operator moves no matrix bytes, reported separately)
        v0 = jnp.asarray(rng.standard_normal(A_var.grid).astype(np.float32))
        t_st = spmv_timed(
            lambda Ad, v: as_operator(Ad)(v), A_var.astype(jnp.float32), v0, k_spmv
        )
        stencil_metrics = {
            "us": round(t_st * 1e6, 1),
            "gflops": round(2.0 * A_var.nlegs * n / t_st / 1e9, 1),
            "gnnz_per_s": round(A_var.nnz / t_st / 1e9, 2),
            **spmv_rate((A_var.nlegs + 2) * 4.0 * n, t_st),
        }
        if h.levels and A is not A_var:
            t_cst = spmv_timed(
                lambda Ad, v: as_operator(Ad)(v), A.astype(jnp.float32), v0, k_spmv
            )
            stencil_metrics["const_us"] = round(t_cst * 1e6, 1)
            stencil_metrics["const_gflops"] = round(2.0 * A_var.nlegs * n / t_cst / 1e9, 1)
        record["spmv_stencil"] = stencil_metrics

    def dia_row(n_band: int, k_pair) -> dict:
        Ab = generators.banded_sin_matrix(n_band, 160, dtype=np.float32).device_put()
        vb = jnp.asarray(rng.standard_normal(n_band).astype(np.float32))
        t = spmv_timed(lambda Ad, v: as_operator(Ad)(v), Ab, vb, k_pair)
        return {
            "us": round(t * 1e6, 1),
            "gflops": round(2.0 * Ab.ndiags * n_band / t / 1e9, 1),
            "gnnz_per_s": round(Ab.nnz / t / 1e9, 2),
            **spmv_rate((Ab.ndiags + 2) * 4.0 * n_band, t),
        }

    @section("spmv_dia", floor_s=180.0)
    def _spmv_dia():
        # the reference's band-160 |sin| family (no grid structure -> the
        # flat XLA DIA path): n=207,360, the flagship's size
        record["spmv_dia_band160"] = dia_row(207_360, k_spmv)

    @section("spmv_dia_2M", floor_s=180.0)
    def _spmv_dia_2m():
        # n=2.07M: a 1.3 GB coefficient stream, far past any cache
        record["spmv_dia_band160_2M"] = dia_row(2_073_600, (16, 528))

    @section("dia_validation", floor_s=60.0)
    def _dia_validation():
        # the XLA DIA SpMV / SpMM and the const stencil against the fp64
        # oracle (small systems, fp32 tolerance)
        from conjugategradient_tpu.core.formats import dia_to_stencil, stencil_to_const
        from conjugategradient_tpu.ops.spmm import spmm
        from conjugategradient_tpu.ops.stencil import spmv_const_stencil

        A32 = generators.banded_sin_matrix(20_000, 160, dtype=np.float32)
        Av = A32.device_put()
        xv = np.random.default_rng(0).standard_normal(20_000).astype(np.float32)
        y_o = oracle.spmv(A32, xv.astype(np.float64))
        y_d = np.asarray(jax.jit(as_operator(Av))(jnp.asarray(xv)), np.float64)
        dia_err = float(np.abs(y_d - y_o).max() / np.abs(y_o).max())
        assert dia_err < 1e-5, f"DIA SpMV vs oracle: {dia_err}"
        Xv = np.random.default_rng(1).standard_normal((20_000, 4)).astype(np.float32)
        Ym = np.asarray(jax.jit(spmm)(Av, jnp.asarray(Xv)), np.float64)
        Ym_o = np.stack([oracle.spmv(A32, Xv[:, j].astype(np.float64))
                         for j in range(4)], axis=1)
        spmm_err = float(np.abs(Ym - Ym_o).max() / np.abs(Ym_o).max())
        assert spmm_err < 1e-5, f"DIA SpMM vs oracle: {spmm_err}"
        gs = (33, 31, 29)
        ssys = generators.poisson_system(gs, dtype=np.float32)
        Ast = stencil_to_const(dia_to_stencil(ssys.A, gs))
        xs = np.random.default_rng(2).standard_normal(gs).astype(np.float32)
        y_s = np.asarray(jax.jit(spmv_const_stencil)(Ast, jnp.asarray(xs)), np.float64)
        y_so = oracle.spmv(ssys.A, xs.reshape(-1).astype(np.float64))
        st_err = float(np.abs(y_s.reshape(-1) - y_so).max() / np.abs(y_so).max())
        assert st_err < 1e-5, f"const stencil vs oracle: {st_err}"
        record["dia_spmv_vs_oracle_relerr"] = dia_err
        record["dia_spmm_vs_oracle_relerr"] = spmm_err
        record["stencil_vs_oracle_relerr"] = st_err

    @section("amg_cg_511sq", floor_s=240.0)
    def _amg():
        # grid-free AMG-CG on the 511^2 Poisson handed over as bare CSR —
        # the blocked (gather-free) aggregation path
        from conjugategradient_tpu.core.io import from_scipy, to_scipy
        from conjugategradient_tpu.precond.amg import (
            amg_preconditioner,
            build_amg_hierarchy,
        )

        asys = generators.poisson_system((511, 511), dtype=np.float32)
        A_csr = from_scipy(to_scipy(asys.A).tocsr())
        apol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=2000)
        ab = jnp.asarray(asys.b, dtype=np.float32)
        h_amg = build_amg_hierarchy(A_csr, dtype=np.float32)

        def run_amg(h_, A_, b_, scales):
            M = amg_preconditioner(h_)

            def step(prev_x, sc):
                res = cg_solve(
                    A_, b_ * sc + 1e-30 * prev_x, policy=apol, M=M,
                    precise_dot=True,
                )
                return res.x, (res.iterations, res.residual, res.converged)

            x, aux = jax.lax.scan(step, jnp.zeros_like(b_), scales)
            return x, aux

        runj = jax.jit(run_amg)
        A0 = h_amg.levels[0].A
        times = {}
        aux = None
        for k in (2, 22):
            scales = jnp.asarray(1.0 + rng.uniform(1e-5, 1e-3, k).astype(np.float32))
            o = runj(h_amg, A0, ab, scales)
            jax.block_until_ready(o)
            best = float("inf")
            for _ in range(3):
                scales = jnp.asarray(1.0 + rng.uniform(1e-5, 1e-3, k).astype(np.float32))
                t0 = time.perf_counter()
                o = runj(h_amg, A0, ab, scales)
                float(np.asarray(o[1][1]).ravel()[-1])
                best = min(best, time.perf_counter() - t0)
            times[k] = best
            aux = o[1]
        per = max((times[22] - times[2]) / 20, 1e-9)
        assert bool(np.asarray(aux[2]).all()), "AMG-CG failed"
        lvl0 = h_amg.levels[0]
        record["amg_cg_511sq"] = {
            "ms": round(per * 1e3, 3),
            "its": int(np.asarray(aux[0])[-1]),
            "aggregation": (
                "nd_cubes_stencil" if lvl0.blk_nd is not None
                else "blocked" if lvl0.blk else "greedy"
            ),
        }

    @section("flagship_refined", floor_s=180.0)
    def _flagship():
        # one reference workload time: cublas_flagship through mixed-precision
        # refinement (the fp64-tolerance path from fp32 device solves)
        from conjugategradient_tpu.models import WORKLOADS
        from conjugategradient_tpu.solvers.refine import refined_solve

        w = WORKLOADS["cublas_flagship"]
        fsys = w.build(dtype=np.float64)
        best = float("inf")
        rres = None
        # first call traces; the module-cached inner jits make repeats cheap
        for _ in range(3):
            t0 = time.perf_counter()
            rres = refined_solve(
                fsys.A, fsys.b, fsys.x0, tol=w.policy.tol, norm=w.policy.norm,
                inner_tol=1e-4, device_dtype=np.float32,
            )
            best = min(best, time.perf_counter() - t0)
        abs_res = float(np.linalg.norm(fsys.b - oracle.spmv(fsys.A, rres.x)))
        assert rres.converged, f"flagship refinement did not converge ({rres.residual:.3e})"
        assert abs_res < w.policy.tol, f"flagship |r|_2 {abs_res:.3e} >= {w.policy.tol}"
        record["flagship_refined_s"] = round(best, 3)
        record["flagship_abs_residual"] = abs_res

    record["bench_wall_s"] = round(time.monotonic() - _T0, 1)
    print(json.dumps(record), flush=True)
    if record["sections_failed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
