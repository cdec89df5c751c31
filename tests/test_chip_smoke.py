"""``chip_smoke.py``, ``bench.py`` and the process set-up helper, on the CPU.

The phase functions run here at toy sizes, called directly; ``main`` must
refuse the CPU, and so must ``bench.py``.  The one GPU-marked test runs a
few phases on the card (``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``).
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from conjugategradient_tpu.utils import runtime

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_the_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.setup_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_wins_and_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_require_gpu_raises_on_cpu():
    with pytest.raises(runtime.NoGPUError, match="no GPU found"):
        runtime.require_gpu()


def test_chip_smoke_main_refuses_cpu(capsys, restore_cache_dir):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


def test_bench_refuses_cpu(capsys, restore_cache_dir):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    assert "no GPU found" in capsys.readouterr().out


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_mgcg_2d_with_plain_cg():
    out = chip_smoke.phase_mgcg((63, 63))
    assert out["mgcg"]["iterations"] < out["plain_cg"]["iterations"]
    assert out["mgcg"]["true_rel_residual"] <= chip_smoke.TRUE_TOL
    assert "temp_mb" in out["mgcg"]["memory"]


def test_phase_mgcg_3d():
    out = chip_smoke.phase_mgcg((15, 15, 15), plain_cg=False)
    assert out["levels"] >= 2 and "plain_cg" not in out


def test_phase_level0_kernels_reports_rates():
    out = chip_smoke.phase_level0_kernels((15, 15, 15), copy_words=1 << 14)
    for name in ("spmv", "cheb2_smoother"):
        assert out[name]["us"] > 0 and out[name]["share_of_copy"] > 0


def test_phase_band_spmv():
    out = chip_smoke.phase_band_spmv(n=3001, band=16, copy_words=1 << 14)
    assert out["max_rel_err"] <= 1e-5 and out["ndiags"] == 15


def test_phase_flagship_small():
    out = chip_smoke.phase_flagship(n=2000)
    assert out["abs_residual"] < 1e-8 and out["rel_diff_vs_native_cg"] <= 1e-6


def test_phase_amg():
    out = chip_smoke.phase_amg((31, 31))
    assert out["true_rel_residual"] <= chip_smoke.TRUE_TOL


def test_phase_eft():
    out = chip_smoke.phase_eft(n=1 << 12)
    assert out["two_prod_max_abs_err"] == 0.0
    assert 1e7 < out["condition"] < 1e9
    assert out["dot2_cancelling_rel_err"] <= 1e-5
    assert out["plain_cancelling_rel_err"] > 0.5  # the data tells them apart


@pytest.mark.parametrize("n", [2, 1000, 1 << 14])
def test_cancelling_products_round_to_zero_sum(n):
    a, b, exact = chip_smoke.cancelling_products(n, seed=n)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (n,)
    rounded = a * b  # fp32 products
    assert set(np.abs(rounded).tolist()) == {1.0}
    assert rounded.sum(dtype=np.float64) == 0.0
    assert exact == math.fsum(a.astype(np.float64) * b.astype(np.float64)) > 0


def test_cancelling_products_catch_a_dot_without_error_terms():
    a, b, exact = chip_smoke.cancelling_products(1 << 12)
    p = (a * b).astype(np.float64)  # what a dot2 with e == 0 would add up
    assert abs(math.fsum(p) - exact) / exact == 1.0


def test_split_model_matches_the_device_split():
    from conjugategradient_tpu.ops.precision import _split

    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    hi, lo = _split(jax.numpy.asarray(x))
    mhi, mlo = chip_smoke._split_model(x)
    np.testing.assert_array_equal(np.asarray(hi, np.float64), mhi)
    np.testing.assert_array_equal(np.asarray(lo, np.float64), mlo)


def test_hlo_dir_writes_named_programs(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "HLO_DIR", tmp_path / "hlo")
    chip_smoke.phase_band_spmv(n=501, band=8, copy_words=1 << 12)
    text = (tmp_path / "hlo" / "c_dia_spmv.hlo.txt").read_text()
    assert "HloModule" in text and "fusion" in text


def test_phase_failure_is_reported_not_raised(capsys):
    def broken():
        chip_smoke.check(False, "deliberately outside tolerance")

    assert chip_smoke.run_phases([("ok", lambda: {}), ("bad", broken)]) is False
    out = capsys.readouterr().out
    assert '"phase": "ok", "ok": true' in out
    assert "deliberately outside tolerance" in out


def test_phase_sharded_cg_on_four_virtual_devices():
    out = chip_smoke.phase_sharded_cg(jax.devices()[:4], n=1024)
    assert out["cards"] == 4
    assert abs(out["iterations"] - out["iterations_one_card"]) <= 1


def test_phase_shard_mgcg_on_four_virtual_devices():
    out = chip_smoke.phase_shard_mgcg(jax.devices()[:4], grid=(64, 64))
    assert out["cards"] == 4 and out["solution_gap"] <= chip_smoke.TRUE_TOL


def test_ill_conditioned_pair_is_exact_and_conditioned():
    a, b, exact, cond = chip_smoke.ill_conditioned_pair(1000, 1e6, seed=3)
    assert a.dtype == b.dtype == np.float32
    assert 1e5 < cond < 1e7
    assert exact == math.fsum(a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.gpu
def test_phases_on_the_card(gpu_devices):
    """The compiled kernels on the card at reduced sizes (the full sizes are
    ``python chip_smoke.py``)."""
    assert chip_smoke.phase_eft(n=1 << 16)["two_prod_max_abs_err"] == 0.0
    assert chip_smoke.phase_mgcg((255, 255))["mgcg"]["true_rel_residual"] <= chip_smoke.TRUE_TOL
    assert chip_smoke.phase_band_spmv(n=50_000)["max_rel_err"] <= 1e-5
