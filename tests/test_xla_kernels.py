"""The plain-XLA operators on the shapes the old hand-written slab and
column-major kernels served, against independent fp64 references.

- grid stencils (const and variable legs, fp32 and bf16 legs) on 2-D/3-D
  grids with ragged, odd and 2^k-1 extents, against ``core.oracle``;
- the Chebyshev smoother (and its correction residual), unfused, against a
  numpy recurrence;
- flat DIA SpMV/SpMM with random and large offsets at sizes that are not a
  multiple of anything, against ``core.oracle``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from conjugategradient_tpu.core import generators, oracle
from conjugategradient_tpu.core.formats import DiaMatrix, dia_to_stencil, stencil_to_const
from conjugategradient_tpu.ops.spmm import spmm
from conjugategradient_tpu.ops.spmv import spmv
from conjugategradient_tpu.ops.stencil import spmv_const_stencil, spmv_stencil
from conjugategradient_tpu.precond.smoothers import chebyshev_smooth

STENCIL_GRIDS = [(17, 13, 11), (33, 31, 29), (23, 9, 12), (25, 19), (128, 128), (260, 31)]


def _np_stencil(legs, shifts, x):
    """fp64 numpy reference: y = sum_k leg_k * x shifted by shifts[k], with
    zero padding outside the grid."""
    x = np.asarray(x, np.float64)
    halo = [max(abs(s[ax]) for s in shifts) for ax in range(x.ndim)]
    xp = np.pad(x, [(h, h) for h in halo])
    y = np.zeros_like(x)
    for leg, sh in zip(legs, shifts):
        sl = tuple(slice(h + s, h + s + g) for h, s, g in zip(halo, sh, x.shape))
        y += np.asarray(leg, np.float64) * xp[sl]
    return y


@pytest.mark.parametrize("grid", STENCIL_GRIDS)
@pytest.mark.parametrize("kind", ["const", "variable", "variable_bf16"])
def test_stencil_spmv_matches_oracle(grid, kind):
    rng = np.random.default_rng(len(grid) * 100 + grid[0])
    x = rng.standard_normal(grid).astype(np.float32)
    if kind == "const":
        sys_ = generators.poisson_system(grid, dtype=np.float64)
        A = stencil_to_const(dia_to_stencil(sys_.A, grid))
        assert A is not None
        y = np.asarray(spmv_const_stencil(A, jnp.asarray(x)), np.float64)
        y_ref = oracle.spmv(sys_.A, x.reshape(-1).astype(np.float64)).reshape(grid)
    else:
        sys_ = generators.diffusion_system(grid, kind="jump", dtype=np.float64)
        A = dia_to_stencil(sys_.A, grid).device_put(np.float32)
        if kind == "variable_bf16":
            A = A.astype(jnp.bfloat16)
            y_ref = _np_stencil([np.asarray(l, np.float32) for l in A.data], A.shifts, x)
        else:
            y_ref = oracle.spmv(sys_.A, x.reshape(-1).astype(np.float64)).reshape(grid)
        y = np.asarray(spmv_stencil(A, jnp.asarray(x)), np.float64)
    assert y.shape == tuple(grid)
    err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert err < 2e-6, err


def _cheb_reference(legs, shifts, invd, b, x, degree, hi, lo):
    """The Chebyshev three-term recurrence in fp64 numpy."""
    op = lambda v: _np_stencil(legs, shifts, v)
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = invd * (b - op(x))
    d = r / theta
    for _ in range(degree):
        x = x + d
        r = r - invd * op(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x, invd * (b - op(x))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("x0_zero", [True, False])
@pytest.mark.parametrize("want_resid", [False, True])
def test_chebyshev_smoother_matches_reference(degree, x0_zero, want_resid):
    """Every variant the fused slab smoother covered — zero/nonzero initial
    guess, with and without the correction residual — on a ragged 3-D grid,
    as the V-cycle runs them: unfused, one XLA program per call."""
    from functools import partial

    import jax

    g = (24, 9, 12)
    sys_ = generators.poisson_system(g, dtype=np.float64)
    A = stencil_to_const(dia_to_stencil(sys_.A, g))
    centre = list(A.shifts).index((0, 0, 0))
    invd = 1.0 / A.coeffs[centre]
    op = partial(spmv_const_stencil, A)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(g).astype(np.float32)
    x0 = np.zeros(g, np.float32) if x0_zero else rng.standard_normal(g).astype(np.float32)
    hi, lo = 1.9, 0.45

    @jax.jit
    def smooth(b_, x_):
        x = chebyshev_smooth(op, jnp.float32(invd), b_, x_, degree, hi, lo)
        return (x, jnp.float32(invd) * (b_ - op(x))) if want_resid else x

    out = smooth(jnp.asarray(b), jnp.asarray(x0))
    legs = [np.full(g, c) for c in A.coeffs]
    x_ref, r_ref = _cheb_reference(legs, A.shifts, invd, b.astype(np.float64),
                                   x0.astype(np.float64), degree, hi, lo)
    x = out[0] if want_resid else out
    np.testing.assert_allclose(np.asarray(x, np.float64), x_ref, rtol=2e-5, atol=2e-5)
    if want_resid:
        np.testing.assert_allclose(np.asarray(out[1], np.float64), r_ref, rtol=2e-5, atol=2e-5)


def _random_dia(n, offsets, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), n))
    i = np.arange(n)
    for k, off in enumerate(offsets):
        data[k, (i + off < 0) | (i + off >= n)] = 0.0
    return DiaMatrix(data, tuple(offsets), (n, n))


DIA_CASES = {
    "tridiag_1000": lambda: generators.tridiagonal_matrix(1000),
    "band16_333": lambda: generators.banded_sin_matrix(333, 16),
    "poisson_37sq": lambda: generators.poisson2d_matrix(37),
    "random_offsets_997": lambda: _random_dia(997, (-613, -71, -5, 0, 2, 19, 404), 0),
    "large_offsets_2053": lambda: _random_dia(2053, (-2000, -1027, 0, 1027, 2000), 1),
    "wide_band_1369": lambda: _random_dia(1369, tuple(range(-101, 102, 7)), 2),
}


@pytest.mark.parametrize("case", sorted(DIA_CASES))
@pytest.mark.parametrize("k", [0, 1, 5])
def test_flat_dia_spmv_spmm_match_oracle(case, k):
    """k = 0: SpMV; k >= 1: SpMM with k right-hand sides."""
    A = DIA_CASES[case]()
    A32 = DiaMatrix(np.asarray(A.data, np.float32), A.offsets, A.shape)
    rng = np.random.default_rng(k)
    if k == 0:
        x = rng.standard_normal(A.n).astype(np.float32)
        y = np.asarray(spmv(A32.device_put(), jnp.asarray(x)), np.float64)
        y_ref = oracle.spmv(A32, x.astype(np.float64))
    else:
        X = rng.standard_normal((A.n, k)).astype(np.float32)
        y = np.asarray(spmm(A32.device_put(), jnp.asarray(X)), np.float64)
        y_ref = np.stack([oracle.spmv(A32, X[:, j].astype(np.float64)) for j in range(k)], 1)
    assert y.shape == y_ref.shape
    err = np.abs(y - y_ref).max() / np.abs(y_ref).max()
    assert err < 1e-5, err
