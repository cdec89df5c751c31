#!/usr/bin/env python3
"""Smoke test of the solver stack on the GPU, at the sizes its users run.

    python chip_smoke.py                # phases (a)-(f) on one GPU
    python chip_smoke.py --four-cards   # the distributed solvers on four GPUs
    python chip_smoke.py --hlo-dir DIR  # also write the timed programs' HLO

Every phase drives the public entry points (``build_hierarchy`` +
``cg_solve``, ``refined_solve``, ``build_amg_hierarchy``, ``sharded_cg_solve``,
``shard_mgcg_solve``), compares its result with the fp64 oracle
(``core.oracle``) under a stated tolerance, and prints one line with its
set-up and compile times, iterations, residuals and the compiled program's
``memory_analysis()``.  Phase (b) and (c) also time the level-0 stencil
SpMV, the level-0 Chebyshev smoother and the band-160 DIA SpMV against a
copy rate measured in the same run.

An earlier line gives the card's name and power limit from ``nvidia-smi``.
The last line is one JSON object, ``{"ok": true, "device": {...}}``, printed
only when every phase passed.  The script exits nonzero, and prints no such
line, when JAX finds no GPU, when a phase fails, or when the package is not
beside it.  Everything runs in this one process: a second JAX process on the
card would find its memory already reserved.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

#: Relative fp32 solver tolerance of the MGCG/CG/AMG phases, and the bound
#: on the TRUE fp64 relative residual: 10x looser, for the fp32 gap between
#: the recurrence residual and the true residual.
SOLVE_TOL = 1e-6
TRUE_TOL = 1e-5


class PhaseFailure(AssertionError):
    """A phase's result is outside its stated tolerance."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def import_package():
    """Import the package that sits beside this script, or exit nonzero."""
    sys.path.insert(0, str(HERE))
    try:
        import conjugategradient_tpu as pkg
    except ImportError as e:
        sys.exit(f"chip_smoke.py: the solver package is not beside this script ({e})")
    if Path(pkg.__file__).resolve().parent.parent != HERE:
        sys.exit(f"chip_smoke.py: imported {pkg.__file__}, not the package beside this script")
    return pkg


def memory_mb(compiled) -> dict:
    """``compiled.memory_analysis()`` in MB (argument/output/temp/code)."""
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k.replace("_size_in_bytes", "_mb"): round(getattr(ma, k, 0) / 1e6, 3)
            for k in keys}


#: Where ``compile_jit`` writes each named program's optimized HLO
#: (``--hlo-dir``); None writes nothing.
HLO_DIR: Path | None = None


def compile_jit(fn, *args, name=None):
    """AOT-compile ``jax.jit(fn)`` for ``args``; returns (compiled, seconds).
    With ``HLO_DIR`` set, a named program's optimized HLO goes to
    ``HLO_DIR/<name>.hlo.txt``: it shows which fusions XLA made."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    seconds = time.perf_counter() - t0
    if HLO_DIR is not None and name is not None:
        HLO_DIR.mkdir(parents=True, exist_ok=True)
        (HLO_DIR / f"{name}.hlo.txt").write_text(compiled.as_text())
    return compiled, seconds


def run_timed(compiled, *args):
    """Run twice; return (result, seconds of the second, warm run)."""
    import jax

    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, time.perf_counter() - t0


def true_rel_residual(A64, b64, x) -> float:
    from conjugategradient_tpu.core import oracle

    x = np.asarray(x, dtype=np.float64).reshape(-1)
    r = np.asarray(b64, np.float64) - oracle.spmv(A64, x)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def solution_gap(A64, b64, x, y) -> float:
    """||A (x - y)|| / ||b||: how far apart two solutions are, in the norm
    the solver tolerance is stated in (two solves that each meet a relative
    residual tol differ by at most 2 tol here, while x - y itself may be
    up to cond(A) times larger)."""
    from conjugategradient_tpu.core import oracle

    d = np.asarray(x, np.float64).reshape(-1) - np.asarray(y, np.float64).reshape(-1)
    return float(np.linalg.norm(oracle.spmv(A64, d)) / np.linalg.norm(b64))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


# --------------------------------------------------------------------------
# phases (module-level functions so the tests can call them at toy sizes)
# --------------------------------------------------------------------------


def _mgcg_case(grid, dtype=np.float32):
    """Poisson system + the headline hierarchy: rediscretized const-stencil
    levels, Chebyshev(2, 2)."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.precond import build_hierarchy

    system = generators.poisson_system(grid, dtype=np.float64)
    t0 = time.perf_counter()
    h = build_hierarchy(
        system.A, grid, smoother="chebyshev", pre=2, post=2, dtype=dtype,
        coarse_operator=generators.poisson_coarse_operator(dtype),
    )
    setup_s = time.perf_counter() - t0
    b = jnp.asarray(system.b, dtype=dtype).reshape(grid)
    return system, h, b, setup_s


def phase_mgcg(grid=(1023, 1023), plain_cg=True) -> dict:
    """(a)/(b): MGCG (and optionally plain CG) on the d-D Poisson system.
    Pass: converged, and the true fp64 relative residual <= TRUE_TOL."""
    from conjugategradient_tpu.precond import as_preconditioner
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    grid = tuple(grid)
    system, h, b, setup_s = _mgcg_case(grid)
    A = h.levels[0].A
    policy = ConvergencePolicy(tol=SOLVE_TOL, norm="rel_l2", max_iteration=8 * system.n)
    out = {"n": system.n, "grid": list(grid), "levels": len(h.levels) + 1,
           "setup_s": round(setup_s, 3)}

    def mgcg(h_, A_, b_):
        return cg_solve(A_, b_, policy=policy, M=as_preconditioner(h_), precise_dot=True)

    solvers = [("mgcg", mgcg, (h, A, b))]
    if plain_cg:
        def plain(A_, b_):
            return cg_solve(A_, b_, policy=policy, precise_dot=True)

        solvers.append(("plain_cg", plain, (A, b)))
    for name, fn, args in solvers:
        compiled, compile_s = compile_jit(fn, *args)
        res, solve_s = run_timed(compiled, *args)
        rel = true_rel_residual(system.A, system.b, res.x)
        out[name] = {
            "compile_s": round(compile_s, 3), "solve_s": solve_s,
            "iterations": int(res.iterations), "recurrence_residual": float(res.residual),
            "true_rel_residual": rel, "memory": memory_mb(compiled),
        }
        check(bool(res.converged), f"{name} {grid} did not converge ({float(res.residual):.3e})")
        check(rel <= TRUE_TOL, f"{name} {grid}: true relative residual {rel:.3e} > {TRUE_TOL}")
    return out


def phase_level0_kernels(grid=(255, 255, 255), copy_words=1 << 26) -> dict:
    """Level-0 const-stencil SpMV and Chebyshev(2) smoother of the MGCG
    hierarchy, timed against the same-run copy rate.  ``min_bytes`` is the
    least traffic of each op: SpMV reads x, writes y; the smoother (what a
    fused kernel would move) reads b and x, writes x."""
    import jax.numpy as jnp

    from conjugategradient_tpu.ops.spmv import as_operator
    from conjugategradient_tpu.precond.smoothers import chebyshev_smooth
    from conjugategradient_tpu.utils.timers import copy_rate_gb_s, per_step_seconds

    grid = tuple(grid)
    system, h, b, _ = _mgcg_case(grid)
    lvl = h.levels[0]
    op = as_operator(lvl.A)
    n = system.n
    copy = copy_rate_gb_s(copy_words)
    x0 = jnp.asarray(np.random.default_rng(0).standard_normal(grid), jnp.float32)
    scale = jnp.float32(1.0 / (2.0 * float(np.max(np.abs(lvl.A.coeffs)))))
    lo, hi = lvl.cheb_bounds
    rows = {}
    for name, step, words in (
        ("spmv", lambda x, b_: op(x) * scale, 2),
        ("cheb2_smoother",
         lambda x, b_: chebyshev_smooth(op, lvl.inv_diag, b_, x, 2, hi, lo), 3),
    ):
        if HLO_DIR is not None:
            compile_jit(step, x0, b, name=f"b_level0_{name}")
        t = per_step_seconds(step, x0, b)
        gb_s = words * 4 * n / t / 1e9
        rows[name] = {"us": t * 1e6, "min_bytes_gb_s": gb_s,
                      "share_of_copy": gb_s / copy}
    return {"n": n, "grid": list(grid), "copy_gb_s": copy, **rows}


def phase_band_spmv(n=2_073_600, band=160, copy_words=1 << 26) -> dict:
    """(c): flat band-160 DIA SpMV.  Pass: max|y - y_oracle| / max|y_oracle|
    <= 1e-5 (a 160-term fp32 sum is good to ~1e-6); timed against the copy
    rate (stream = coefficients + x + y)."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.ops.spmv import spmv
    from conjugategradient_tpu.utils.timers import copy_rate_gb_s, per_step_seconds

    t0 = time.perf_counter()
    A32 = generators.banded_sin_matrix(n, band, dtype=np.float32)
    setup_s = time.perf_counter() - t0
    A = A32.device_put()
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    compiled, compile_s = compile_jit(spmv, A, jnp.asarray(x), name="c_dia_spmv")
    y = np.asarray(compiled(A, jnp.asarray(x)), np.float64)
    y_ref = oracle.spmv(A32, x.astype(np.float64))
    err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    # Gershgorin: the diagonal is the row's off-diagonal sum, so the
    # spectral radius is at most 2 max|a_ii| and the chain stays bounded
    scale = jnp.float32(1.0 / (2.0 * float(np.abs(A32.data).max())))
    t = per_step_seconds(lambda v, A_: spmv(A_, v) * scale, jnp.asarray(x), A)
    stream = (A32.ndiags + 2) * 4 * n
    copy = copy_rate_gb_s(copy_words)
    out = {"n": n, "ndiags": A32.ndiags, "setup_s": round(setup_s, 3),
           "compile_s": round(compile_s, 3), "max_rel_err": err, "us": t * 1e6,
           "stream_gb": stream / 1e9, "gb_s": stream / t / 1e9,
           "share_of_copy": stream / t / 1e9 / copy, "copy_gb_s": copy,
           "memory": memory_mb(compiled)}
    check(err <= 1e-5, f"band-{band} DIA SpMV max relative error {err:.3e} > 1e-5")
    return out


def phase_flagship(n=None) -> dict:
    """(d): the reference flagship through ``refined_solve`` to its own
    absolute fp64 ||r||_2 < 1e-8; the solution must match the native fp64
    CG to relative 1e-6."""
    import jax.numpy as jnp

    from conjugategradient_tpu import native
    from conjugategradient_tpu.core import generators, oracle
    from conjugategradient_tpu.core.formats import dia_to_csr
    from conjugategradient_tpu.models import WORKLOADS
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy
    from conjugategradient_tpu.solvers.refine import refined_solve

    w = WORKLOADS["cublas_flagship"]
    if n is None:
        system = w.build(dtype=np.float64)
    else:  # toy size for tests: the same generator family
        system = generators.banded_sin_system(n, w.band, dtype=np.float64)
    tol = w.policy.tol
    t0 = time.perf_counter()
    res = refined_solve(system.A, system.b, system.x0, tol=tol, norm=w.policy.norm,
                        device_dtype=np.float32)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = refined_solve(system.A, system.b, system.x0, tol=tol, norm=w.policy.norm,
                        device_dtype=np.float32)
    warm_s = time.perf_counter() - t0
    r = system.b - oracle.spmv(system.A, res.x)
    abs_res = float(np.linalg.norm(r))
    ref = native.cg(dia_to_csr(system.A), system.b, system.x0, tol=tol,
                    norm=w.policy.norm, min_iteration=w.policy.min_iteration)
    rel_x = float(np.linalg.norm(res.x - ref.x) / np.linalg.norm(ref.x))
    # the inner fp32 program refined_solve runs, compiled here for its stats
    A32 = system.A.device_put(np.float32)
    r32 = jnp.asarray(r / np.abs(r).max() if abs_res > 0 else r, jnp.float32)
    pol = ConvergencePolicy(tol=1e-5, norm="rel_l2", max_iteration=8 * system.A.n)
    compiled, compile_s = compile_jit(
        lambda A_, v: cg_solve(A_, v, policy=pol, precise_dot=True), A32, r32)
    out = {"n": system.A.n, "outer": res.outer_iterations,
           "inner_iterations": res.inner_iterations, "abs_residual": abs_res,
           "first_call_s": round(first_s, 3), "warm_s": warm_s,
           "rel_diff_vs_native_cg": rel_x, "native_cg_iterations": ref.iterations,
           "inner_compile_s": round(compile_s, 3), "memory": memory_mb(compiled)}
    check(res.converged, f"refined_solve did not converge (residual {res.residual:.3e})")
    check(abs_res < tol, f"flagship |r|_2 {abs_res:.3e} >= {tol}")
    check(rel_x <= 1e-6, f"flagship solution differs from native fp64 CG by {rel_x:.3e}")
    return out


def phase_amg(grid=(511, 511)) -> dict:
    """(e): AMG-CG on the Poisson system handed over as bare CSR.
    Pass: converged at rel-L2 SOLVE_TOL, true residual <= TRUE_TOL."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond.amg import amg_preconditioner, build_amg_hierarchy
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    system = generators.poisson_system(tuple(grid), dtype=np.float64)
    A_csr = from_scipy(to_scipy(system.A).tocsr())
    t0 = time.perf_counter()
    h = build_amg_hierarchy(A_csr, dtype=np.float32)
    setup_s = time.perf_counter() - t0
    b = jnp.asarray(system.b, jnp.float32)
    policy = ConvergencePolicy(tol=SOLVE_TOL, norm="rel_l2", max_iteration=2000)

    def amg_cg(h_, b_):
        return cg_solve(h_.levels[0].A, b_, policy=policy, M=amg_preconditioner(h_),
                        precise_dot=True)

    compiled, compile_s = compile_jit(amg_cg, h, b)
    res, solve_s = run_timed(compiled, h, b)
    rel = true_rel_residual(system.A, system.b, res.x)
    out = {"n": system.n, "levels": len(h.levels) + 1, "setup_s": round(setup_s, 3),
           "compile_s": round(compile_s, 3), "solve_s": solve_s,
           "iterations": int(res.iterations), "recurrence_residual": float(res.residual),
           "true_rel_residual": rel, "memory": memory_mb(compiled)}
    check(bool(res.converged), f"AMG-CG did not converge ({float(res.residual):.3e})")
    check(rel <= TRUE_TOL, f"AMG-CG true relative residual {rel:.3e} > {TRUE_TOL}")
    return out


def ill_conditioned_pair(n: int, cond: float, seed: int = 0):
    """fp32 vectors whose dot product has condition number ~``cond``
    (sum|a_i b_i| / |sum a_i b_i|): random terms with spread exponents, then
    one last term that cancels all but ~sum|a b| / cond.  Returns
    (a, b, exact dot as a Python float, realised condition number)."""
    rng = np.random.default_rng(seed)
    half = 0.5 * math.log2(cond)
    e = np.round(rng.uniform(0, half, n - 1))
    a = ((2 * rng.random(n - 1) - 1) * 2.0 ** e).astype(np.float32)
    b = ((2 * rng.random(n - 1) - 1) * 2.0 ** e).astype(np.float32)
    p = a.astype(np.float64) * b.astype(np.float64)  # exact products
    s = math.fsum(p)
    target = math.fsum(np.abs(p)) / cond
    a = np.append(a, np.float32(1.0))
    b = np.append(b, np.float32(target - s))
    exact = math.fsum(np.append(p, float(b[-1])))
    realised = math.fsum(np.abs(np.append(p, float(b[-1])))) / abs(exact)
    return a, b, exact, realised


def _split_model(x):
    """numpy model of ``ops.precision._split`` for fp32: round away the
    low 12 significand bits on the bit pattern."""
    bits = x.view(np.uint32)
    bits = (bits + np.uint32(1 << 11)) & ~np.uint32((1 << 12) - 1)
    hi = bits.view(np.float32)
    return hi.astype(np.float64), (x - hi).astype(np.float64)


def cancelling_products(n: int, seed: int = 0):
    """fp32 vectors (n even) whose products all round to exactly +1 or -1,
    n/2 of each, while each exact product misses its rounded value by a
    rounding error that carries the product's sign.  Any summation order
    adds the rounded products exactly, to 0, so the exact dot is the sum of
    the rounding errors alone (condition ~2^26): a plain fp32 dot returns
    ~0, ``dot2`` recovers the sum to tree-sum accuracy only if its
    error-free product is exact, and a broken split is off by O(1).
    Only pairs are kept whose product rounds to 1 both at once and as
    ``two_prod`` forms it, fl(hi*hi + cross terms).
    Returns (a, b, exact dot as a Python float)."""
    rng = np.random.default_rng(seed)
    b = (1 + rng.random(4 * n)).astype(np.float32)
    a = (1 / b.astype(np.float64)).astype(np.float32)
    prod = a.astype(np.float64) * b.astype(np.float64)  # exact
    (ah, al), (bh, bl) = _split_model(a), _split_model(b)
    head = (ah * bh + (ah * bl + al * bh)).astype(np.float32)
    ok = (prod.astype(np.float32) == 1.0) & (head == 1.0)
    up = np.flatnonzero(ok & (prod > 1))[: n // 2]
    down = np.flatnonzero(ok & (prod < 1))[: n - n // 2]
    if len(up) + len(down) < n:
        raise ValueError(f"drew too few cancelling pairs for n={n}")
    pick = np.concatenate([up, down])
    sign = np.where(prod[pick] > 1, 1, -1).astype(np.float32)
    a, b = a[pick] * sign, b[pick]
    exact = math.fsum(a.astype(np.float64) * b.astype(np.float64))
    return a, b, exact


def phase_eft(n=1 << 20, cond=1e8) -> dict:
    """(f): the error-free transforms compiled for the device.  Pass:
    ``two_prod`` is exact on every element (p + e == a * b in fp64);
    ``dd_dot`` is within 1e-5 relative of the exact dot at condition ~1e8
    (double-float accuracy ~2^-48 x cond ~ 4e-7); and on
    ``cancelling_products`` both ``dot2`` and ``dd_dot`` are within 1e-5 of
    the exact dot (a tree sum of n same-signed terms is good to
    log2(n) x 2^-24 ~ 1.2e-6), where a broken split is off by O(1).
    ``dot2``'s and the plain fp32 dot's errors at condition ~1e8 are
    reported beside them: there ``dot2``'s own tree sum of the products
    dominates, so it is not expected to beat the plain dot by much."""
    import jax
    import jax.numpy as jnp

    from conjugategradient_tpu.ops.precision import MATMUL_PRECISION, dd_dot, dot2, two_prod

    rng = np.random.default_rng(7)
    pa = rng.standard_normal(n).astype(np.float32)
    pb = rng.standard_normal(n).astype(np.float32)
    p, e = jax.jit(two_prod)(jnp.asarray(pa), jnp.asarray(pb))
    prod64 = pa.astype(np.float64) * pb.astype(np.float64)
    tp_err = float(np.abs(np.asarray(p, np.float64) + np.asarray(e, np.float64)
                          - prod64).max())
    plain_dot = jax.jit(lambda u, v: jnp.vdot(u, v, precision=MATMUL_PRECISION))
    dots = {"plain": plain_dot, "dot2": jax.jit(dot2), "dd_dot": jax.jit(dd_dot)}
    a, b, exact, realised = ill_conditioned_pair(n, cond)
    c_a, c_b, c_exact = cancelling_products(n)
    out = {"n": n, "condition": realised, "two_prod_max_abs_err": tp_err}
    for name, fn in dots.items():
        v = float(fn(jnp.asarray(a), jnp.asarray(b)))
        out[f"{name}_rel_err"] = abs(v - exact) / abs(exact)
        v = float(fn(jnp.asarray(c_a), jnp.asarray(c_b)))
        out[f"{name}_cancelling_rel_err"] = abs(v - c_exact) / abs(c_exact)
    check(tp_err == 0.0, f"two_prod is not exact on the device (max error {tp_err:.3e})")
    check(out["dd_dot_rel_err"] <= 1e-5,
          f"dd_dot relative error {out['dd_dot_rel_err']:.3e} > 1e-5")
    for name in ("dot2", "dd_dot"):
        err = out[f"{name}_cancelling_rel_err"]
        check(err <= 1e-5, f"{name} on cancelling products: relative error {err:.3e} > 1e-5")
    return out


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------


def phase_sharded_cg(devices, n=None) -> dict:
    """Row-block sharded CG (ppermute halos, psum dots) on the flagship
    system in fp32 from a zero initial guess (so the relative tolerance is
    relative to b), against the same solve on one card and the fp64 oracle
    residual.  Pass: iterations within +-1, ``solution_gap`` <= TRUE_TOL."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.core.partition import pad_system
    from conjugategradient_tpu.models import WORKLOADS
    from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    w = WORKLOADS["cublas_flagship"]
    if n is None:
        system = w.build(dtype=np.float64)
    else:
        system = generators.banded_sin_system(n, w.band, dtype=np.float64)
    policy = ConvergencePolicy(tol=SOLVE_TOL, norm="rel_l2", max_iteration=4 * system.A.n)
    mesh = Mesh(np.array(devices), ("x",))
    # decoupled identity rows up to a multiple of the card count (b = 0
    # there, so the padded solve is the original one plus zeros)
    padded, n = pad_system(system, len(devices))
    t0 = time.perf_counter()
    res_m = sharded_cg_solve(padded.A, padded.b, None, policy, mesh=mesh,
                             dtype=np.float32)
    jax.block_until_ready(res_m.x)
    mesh_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        A1 = system.A.device_put(np.float32)
        res_1 = jax.jit(lambda A_, b_: cg_solve(A_, b_, policy=policy))(
            A1, jnp.asarray(system.b, jnp.float32))
    x_m = np.asarray(res_m.x, np.float64)[:n]
    x_1 = np.asarray(res_1.x, np.float64)
    diff = float(np.linalg.norm(x_m - x_1) / np.linalg.norm(x_1))
    gap = solution_gap(system.A, system.b, x_m, x_1)
    rel_m = true_rel_residual(system.A, system.b, x_m)
    rel_1 = true_rel_residual(system.A, system.b, x_1)
    out = {"n": n, "padded_n": padded.A.n, "cards": len(devices),
           "iterations": int(res_m.iterations),
           "iterations_one_card": int(res_1.iterations), "solution_rel_diff": diff,
           "solution_gap": gap,
           "true_rel_residual": rel_m, "true_rel_residual_one_card": rel_1,
           "first_call_s": round(mesh_s, 3)}
    check(bool(res_m.converged), "sharded CG did not converge")
    check(abs(int(res_m.iterations) - int(res_1.iterations)) <= 1,
          f"sharded CG took {int(res_m.iterations)} iterations, one card {int(res_1.iterations)}")
    check(gap <= TRUE_TOL, f"sharded and one-card solutions differ by {gap:.3e}")
    check(rel_m <= TRUE_TOL, f"sharded CG true relative residual {rel_m:.3e}")
    return out


def phase_shard_mgcg(devices, grid=(4096, 4096)) -> dict:
    """Explicit shard_map MGCG on a 2-D Poisson system (leading extent
    divisible by the card count, even local rows) with the headline
    hierarchy (rediscretized const-stencil levels, hybrid transfers on even
    axes, Chebyshev(2,2)), against MGCG on one card with the same
    hierarchy.  Pass: iterations within +-1, ``solution_gap`` <= TRUE_TOL."""
    import jax
    from jax.sharding import Mesh

    from conjugategradient_tpu.parallel.shard_mgcg import shard_mgcg_solve
    from conjugategradient_tpu.precond import as_preconditioner
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    grid = tuple(grid)
    system, h, b, setup_s = _mgcg_case(grid)
    policy = ConvergencePolicy(tol=SOLVE_TOL, norm="rel_l2", max_iteration=500)
    mesh = Mesh(np.array(devices), ("x",))
    t0 = time.perf_counter()
    res_m = shard_mgcg_solve(system, grid, mesh=mesh, policy=policy, hierarchy=h,
                             dtype=np.float32)
    jax.block_until_ready(res_m.x)
    mesh_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        res_1 = jax.jit(lambda h_, b_: cg_solve(h_.levels[0].A, b_, policy=policy,
                                                M=as_preconditioner(h_)))(h, b)
    x_m = np.asarray(res_m.x, np.float64).reshape(-1)
    x_1 = np.asarray(res_1.x, np.float64).reshape(-1)
    diff = float(np.linalg.norm(x_m - x_1) / np.linalg.norm(x_1))
    gap = solution_gap(system.A, system.b, x_m, x_1)
    rel_m = true_rel_residual(system.A, system.b, x_m)
    out = {"n": system.n, "grid": list(grid), "cards": len(devices),
           "levels": len(h.levels) + 1, "setup_s": round(setup_s, 3),
           "iterations": int(res_m.iterations),
           "iterations_one_card": int(res_1.iterations), "solution_rel_diff": diff,
           "solution_gap": gap,
           "true_rel_residual": rel_m, "first_call_s": round(mesh_s, 3)}
    check(bool(res_m.converged), "shard_map MGCG did not converge")
    check(abs(int(res_m.iterations) - int(res_1.iterations)) <= 1,
          f"shard_map MGCG took {int(res_m.iterations)} iterations, one card "
          f"{int(res_1.iterations)}")
    check(gap <= TRUE_TOL, f"sharded and one-card MGCG solutions differ by {gap:.3e}")
    check(rel_m <= TRUE_TOL, f"shard_map MGCG true relative residual {rel_m:.3e}")
    return out


def phase_dryrun(n_devices: int) -> dict:
    """Breadth check: every distributed design, one tiny solve each."""
    sys.path.insert(0, str(HERE))
    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices)
    return {"cards": n_devices, "seconds": round(time.perf_counter() - t0, 3)}


# --------------------------------------------------------------------------


def run_phases(phases) -> bool:
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — report every phase, then fail
            ok = False
            emit(name, ok=False, error=f"{type(e).__name__}: {e}"[:2000],
                 traceback=traceback.format_exc()[-3000:])
        else:
            emit(name, ok=True, wall_s=round(time.perf_counter() - t0, 3), **out)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed solvers, on four cards")
    ap.add_argument("--hlo-dir", type=Path, default=None,
                    help="write the optimized HLO of the named programs here")
    args = ap.parse_args(argv)
    global HLO_DIR
    HLO_DIR = args.hlo_dir

    import_package()
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
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    print(card_info(), flush=True)
    import jax

    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}", flush=True)

    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke.py: --four-cards needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        used = devices[:4]
        phases = [
            ("sharded_cg_flagship", lambda: phase_sharded_cg(used)),
            ("shard_mgcg_poisson2d", lambda: phase_shard_mgcg(used)),
            ("dryrun_multichip", lambda: phase_dryrun(4)),
        ]
    else:
        used = devices[:1]
        phases = [
            ("a_mgcg_poisson2d_1023", lambda: phase_mgcg((1023, 1023))),
            ("b_mgcg_poisson3d_255", lambda: phase_mgcg((255, 255, 255), plain_cg=False)),
            ("b_level0_kernels_255", lambda: phase_level0_kernels((255, 255, 255))),
            ("c_band160_dia_spmv", phase_band_spmv),
            ("d_flagship_refined", phase_flagship),
            ("e_amg_cg_511", lambda: phase_amg((511, 511))),
            ("f_error_free_transforms", phase_eft),
        ]
    if not run_phases(phases):
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(used)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
