"""Aux-subsystem tests: timers, residual logs, checkpoint/resume."""

import os

import numpy as np
import pytest

from conjugategradient_tpu.core import oracle
from conjugategradient_tpu.core.generators import banded_sin_system, tridiagonal_system
from conjugategradient_tpu.solvers.cg import cg_solve, cg_solve_chunked, cg_solve_traced
from conjugategradient_tpu.solvers.policy import ConvergencePolicy
from conjugategradient_tpu.utils import (
    CGState,
    PhaseTimer,
    load_state,
    records_from_history,
    save_state,
)
from conjugategradient_tpu.utils.reslog import convergence_rate, write_csv, write_jsonl


def test_phase_timer_sync_and_report():
    import jax.numpy as jnp

    t = PhaseTimer()
    with t.phase("input"):
        x = jnp.arange(1000.0)
    with t.phase("solve", sync=lambda: y):
        y = x * 2.0
    rep = t.report(iterations=10)
    assert "input" in rep and "solve" in rep and "us/it" in rep
    assert t["solve"] >= 0 and t.total >= t["solve"]
    assert set(t.as_dict()) == {"input", "solve"}


@pytest.mark.parametrize("operand", [False, True])
def test_per_step_seconds_differences_two_chains(operand):
    import jax.numpy as jnp

    from conjugategradient_tpu.utils import per_step_seconds

    x0 = jnp.ones(4096, jnp.float32)
    if operand:
        t = per_step_seconds(lambda c, w: c * w, x0, jnp.full(4096, 0.5, jnp.float32),
                             ks=(2, 6), tries=2)
    else:
        t = per_step_seconds(lambda c: c * 0.5, x0, ks=(2, 6), tries=2)
    assert 0 < t < 1.0


def test_copy_rate_is_positive_and_finite():
    from conjugategradient_tpu.utils import copy_rate_gb_s

    rate = copy_rate_gb_s(1 << 12, ks=(2, 10), tries=2)
    assert np.isfinite(rate) and rate > 0


def test_residual_records_roundtrip(tmp_path):
    sys_ = banded_sin_system(512, 8)
    res, hist = cg_solve_traced(
        sys_.A.device_put(), np.asarray(sys_.b), np.asarray(sys_.x0),
        ConvergencePolicy(tol=1e-8), num_steps=60,
    )
    recs = records_from_history(hist, iterations=int(res.iterations))
    assert len(recs) == int(res.iterations)
    assert recs[-1].l2 < recs[0].l2
    assert 0 < convergence_rate(recs) < 1
    jp, cp = str(tmp_path / "r.jsonl"), str(tmp_path / "r.csv")
    write_jsonl(jp, recs)
    write_csv(cp, recs)
    assert len(open(jp).readlines()) == len(recs)
    assert open(cp).readline().startswith("iteration,")


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    st = CGState(
        x=rng.standard_normal(16), r=rng.standard_normal(16), p=rng.standard_normal(16),
        rz=1.5, rr=2.5, rr0=3.5, iteration=7,
    )
    path = str(tmp_path / "cg.npz")
    save_state(path, st)
    got = load_state(path)
    np.testing.assert_array_equal(got.x, st.x)
    assert (got.rz, got.rr, got.rr0, got.iteration) == (1.5, 2.5, 3.5, 7)


def test_chunked_cg_matches_plain():
    sys_ = banded_sin_system(1024, 16)
    pol = ConvergencePolicy(tol=1e-8)
    plain = cg_solve(sys_.A.device_put(), np.asarray(sys_.b), np.asarray(sys_.x0), pol)
    chunked = cg_solve_chunked(
        sys_.A.device_put(), np.asarray(sys_.b), np.asarray(sys_.x0), pol, chunk=7
    )
    assert bool(chunked.converged)
    # chunked runs whole chunks, so it may take a few extra (frozen) iterations
    assert abs(int(chunked.iterations) - int(plain.iterations)) <= 1
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(plain.x), rtol=1e-9, atol=1e-12)


def test_chunked_cg_resume_continues_sequence(tmp_path):
    sys_ = tridiagonal_system(2048)
    pol = ConvergencePolicy(tol=1e-8, max_iteration=8192)
    path = str(tmp_path / "state.npz")
    seen = []

    class Stop(Exception):
        pass

    def bail(state):
        seen.append(state.iteration)
        if state.iteration >= 200:
            raise Stop  # simulate process death mid-solve

    with pytest.raises(Stop):
        cg_solve_chunked(
            sys_.A.device_put(), np.asarray(sys_.b), policy=pol,
            chunk=100, checkpoint_path=path, callback=bail,
        )
    assert os.path.exists(path)
    mid = load_state(path)
    assert mid.iteration >= 200

    # resume and finish
    res = cg_solve_chunked(
        sys_.A.device_put(), np.asarray(sys_.b), policy=pol, chunk=500, checkpoint_path=path
    )
    assert bool(res.converged)
    assert int(res.iterations) > mid.iteration
    ref = oracle.cg(sys_.A, sys_.b, tol=1e-8, max_iteration=8192)
    denom = np.maximum(np.abs(ref.x), 1e-3 * np.abs(ref.x).max())
    assert np.max(np.abs(np.asarray(res.x) - ref.x) / denom) < 1e-5


def test_chunked_cg_nonconvergence_flag():
    sys_ = tridiagonal_system(512)
    pol = ConvergencePolicy(tol=1e-30, max_iteration=50)
    res = cg_solve_chunked(sys_.A.device_put(), np.asarray(sys_.b), policy=pol, chunk=20)
    assert not bool(res.converged)
    assert int(res.iterations) == 50  # max_iter respected inside chunks


def test_profiler_trace_writes_artifacts(tmp_path):
    import jax
    import jax.numpy as jnp

    from conjugategradient_tpu.utils import profiler_trace

    d = str(tmp_path / "trace")
    with profiler_trace(d):
        jax.block_until_ready(jnp.arange(1024.0) * 2.0)
    assert os.path.isdir(d) and any(os.scandir(d))
    with profiler_trace(None):  # no-op path
        pass


def test_spy_plot():
    from conjugategradient_tpu.core.generators import poisson2d_matrix, tridiagonal_matrix
    from conjugategradient_tpu.utils.spy import spy, spy_counts

    A = tridiagonal_matrix(100)
    out = spy(A, cells=10)
    assert out.count("\n") == 10  # 10 rows + footer
    g = spy_counts(A, cells=10)
    assert g.shape == (10, 10)
    # band structure: off-band far corners are empty, the diagonal is not
    assert g[0, -1] == 0 and g[-1, 0] == 0 and g[0, 0] > 0
    # 2-D Poisson shows the outer diagonals
    g2 = spy_counts(poisson2d_matrix(31), cells=16)
    assert g2[0, 0] > 0 and np.trace(g2) > 0


def test_residual_records_r0_normalization():
    """rel_l2 must normalise by the INITIAL residual when r0 is passed
    (ADVICE round 1: h[0] is the residual after iteration 1, so the fallback
    pins the first record's rel_l2 to 1.0 and disagrees with the solver)."""
    sys_ = banded_sin_system(512, 8)
    r0_vec = sys_.b - oracle.spmv(sys_.A, sys_.x0)
    r0 = float(np.linalg.norm(r0_vec))
    res, hist = cg_solve_traced(
        sys_.A.device_put(), np.asarray(sys_.b), np.asarray(sys_.x0),
        ConvergencePolicy(tol=1e-8), num_steps=60,
    )
    recs = records_from_history(hist, iterations=int(res.iterations), r0=r0)
    np.testing.assert_allclose(recs[0].rel_l2, recs[0].l2 / r0, rtol=1e-12)
    assert recs[0].rel_l2 != 1.0  # the first iteration made progress
    # fallback keeps the old (documented) behaviour
    recs_fb = records_from_history(hist, iterations=int(res.iterations))
    assert recs_fb[0].rel_l2 == 1.0


def test_chunked_preconditioner_state_as_argument(tmp_path):
    """cg_solve_chunked accepts M as a (fn, state) pair so the preconditioner
    state enters the jitted chunk as a pytree argument (ADVICE round 1)."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core.generators import poisson_system
    from conjugategradient_tpu.precond import build_hierarchy
    from conjugategradient_tpu.precond.multigrid import v_cycle

    grid = (31, 31)
    sys_ = poisson_system(grid)
    h = build_hierarchy(sys_.A, grid, smoother="jacobi", layout="dia")
    pol = ConvergencePolicy(tol=1e-9, norm="rel_l2")
    res = cg_solve_chunked(
        sys_.A.device_put(), jnp.asarray(sys_.b), policy=pol, chunk=8,
        M=(lambda h_, r: v_cycle(h_, r), h),
    )
    assert bool(res.converged)
    r = sys_.b - oracle.spmv(sys_.A, np.asarray(res.x))
    assert np.linalg.norm(r) / np.linalg.norm(sys_.b) < 1e-8


def test_save_load_pytree_hierarchies(tmp_path):
    """Hierarchies round-trip through save_pytree/load_pytree: identical
    preconditioned trajectories and bitwise-equal solutions (geometric and
    algebraic; the AMG one carries mixed DIA/CSR level containers)."""
    import jax.numpy as jnp

    from conjugategradient_tpu.core.generators import poisson_system
    from conjugategradient_tpu.core.io import from_scipy, to_scipy
    from conjugategradient_tpu.precond import as_preconditioner, build_hierarchy
    from conjugategradient_tpu.precond.amg import amg_cg_solve, build_amg_hierarchy
    from conjugategradient_tpu.solvers.cg import cg_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy
    from conjugategradient_tpu.utils.checkpoint import load_pytree, save_pytree

    grid = (64, 64)
    sys_ = poisson_system(grid)
    pol = ConvergencePolicy(tol=1e-8, norm="rel_l2")

    h = build_hierarchy(sys_.A, grid)
    p = str(tmp_path / "h.npz")
    save_pytree(p, h)
    h2 = load_pytree(p)
    assert h2.smoother == h.smoother and len(h2.levels) == len(h.levels)
    assert h2.levels[0].grid == h.levels[0].grid
    r1 = cg_solve(sys_.A.device_put(), jnp.asarray(sys_.b), None, pol,
                  M=as_preconditioner(h))
    r2 = cg_solve(sys_.A.device_put(), jnp.asarray(sys_.b), None, pol,
                  M=as_preconditioner(h2))
    assert int(r1.iterations) == int(r2.iterations)
    np.testing.assert_array_equal(np.asarray(r1.x), np.asarray(r2.x))

    A_csr = from_scipy(to_scipy(sys_.A).tocsr())
    ha = build_amg_hierarchy(A_csr, dtype=np.float64)
    p2 = str(tmp_path / "ha.npz")
    save_pytree(p2, ha)
    ha2 = load_pytree(p2)
    ra1, _ = amg_cg_solve(A_csr, sys_.b, policy=pol, hierarchy=ha)
    ra2, _ = amg_cg_solve(A_csr, sys_.b, policy=pol, hierarchy=ha2)
    assert int(ra1.iterations) == int(ra2.iterations)
    np.testing.assert_array_equal(np.asarray(ra1.x), np.asarray(ra2.x))
