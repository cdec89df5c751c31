"""Grid-stencil SpMV — the fast path for structured matrices.

Unknowns keep their natural grid shape, so every shifted neighbour window
is a static slice of one zero-padded array and XLA fuses the whole stencil
into one streaming loop: the neighbour reads of a plane hit cache, and the
memory traffic is about one read of ``x`` plus one write of ``y`` (plus the
legs, for variable coefficients).  A flat 1-D layout of the same operator
(DIA with offsets ±1, ±nx, ±nx*ny) streams one padded copy of ``x`` per
diagonal instead.  All grid-stencil ops therefore take and return
*grid-shaped* arrays; the solver stack is shape-agnostic (dots/norms reduce
over all axes), so CG state simply stays grid-shaped end-to-end.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.core.formats import ConstStencilMatrix, StencilMatrix


def _as_grid(x: jnp.ndarray, grid):
    """Accept a FLAT (n,) vector (or (n, k) block) where a grid-shaped array
    is the native layout: reshape in, and hand back the inverse reshape.
    A reshape is metadata-only under jit (row-major flat order == grid
    order), so the convenience costs nothing; grid-shaped input passes
    through untouched.  Keeps the solver stack's shape-agnostic contract
    true for stencil operators driven with flat Krylov state.
    """
    nd = len(grid)
    if x.ndim == nd + 1 and x.shape[:nd] == tuple(grid):
        return x, (lambda y: y)  # (*grid, k) block
    if x.ndim == nd and x.shape == tuple(grid):
        return x, (lambda y: y)
    if x.ndim == 1 and x.size == int(np.prod(grid)):
        return x.reshape(grid), (lambda y: y.reshape(-1))
    if x.ndim == 2 and nd > 1 and x.shape[0] == int(np.prod(grid)):
        k = x.shape[1]
        return x.reshape(tuple(grid) + (k,)), (lambda y: y.reshape(-1, k))
    raise ValueError(f"array of shape {x.shape} is not compatible with grid {grid}")


def spmv_stencil(A: StencilMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x on grid-shaped ``x`` via zero-pad + static slices.
    Flat (n,) input is reshaped in/out for free (``_as_grid``).  bf16
    legs stay bf16 in memory; each ``leg * window`` product promotes to the
    vector dtype inside the fused loop."""
    x, back = _as_grid(x, A.grid)
    halo = A.halo
    xp = jnp.pad(x, [(h, h) for h in halo])
    y = None
    for k, shift in enumerate(A.shifts):
        sl = tuple(
            slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid)
        )
        term = A.data[k] * xp[sl]
        y = term if y is None else y + term
    return back(y)


def spmv_stencil_roll(A: StencilMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Same product with cyclic rolls per axis — the GSPMD-friendly variant
    (rolls partition into neighbor collective-permutes; wraparound lands on
    the legs' structural zeros, as in ``ops.spmv.spmv_dia_roll``)."""
    x, back = _as_grid(x, A.grid)
    y = None
    for k, shift in enumerate(A.shifts):
        xs = x
        for ax, s in enumerate(shift):
            if s:
                xs = jnp.roll(xs, -s, axis=ax)
        term = A.data[k] * xs
        y = term if y is None else y + term
    return back(y)


def spmv_const_stencil(A: ConstStencilMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x with zero matrix traffic: per-leg SCALAR coefficients times
    statically shifted windows (boundary behaviour = the zero padding).
    2n words per SpMV vs (nlegs + 2) n for the variable-coefficient
    form."""
    x, back = _as_grid(x, A.grid)
    halo = A.halo
    xp = jnp.pad(x, [(h, h) for h in halo])
    y = None
    for k, shift in enumerate(A.shifts):
        sl = tuple(slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid))
        term = A.coeffs[k] * xp[sl]
        y = term if y is None else y + term
    return back(y)


def spmv_const_stencil_roll(A: ConstStencilMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """Cyclic-roll variant for GSPMD — BUT a plain roll wraps real values
    around the global edges with nothing to mask them (no grid-shaped legs
    holding structural zeros), so edge-crossing legs zero the wrapped slab
    explicitly via a positional mask (an iota compare per sharded axis —
    negligible next to the SpMV itself)."""
    x, back = _as_grid(x, A.grid)
    y = None
    for k, shift in enumerate(A.shifts):
        xs = x
        for ax, s in enumerate(shift):
            if s:
                xs = jnp.roll(xs, -s, axis=ax)
                i = jax.lax.broadcasted_iota(jnp.int32, x.shape, ax)
                g = x.shape[ax]
                ok = (i + s >= 0) & (i + s < g)
                xs = jnp.where(ok, xs, 0)
        term = A.coeffs[k] * xs
        y = term if y is None else y + term
    return back(y)


def spmm_const_stencil(A: ConstStencilMatrix, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for B of shape (*grid, k), constant-coefficient legs.
    Flat (n, k) input is reshaped in/out for free (``_as_grid``)."""
    B, back = _as_grid(B, A.grid)
    halo = A.halo
    pad = [(h, h) for h in halo] + [(0, 0)]
    Bp = jnp.pad(B, pad)
    y = None
    for k, shift in enumerate(A.shifts):
        sl = tuple(
            slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid)
        ) + (slice(None),)
        term = A.coeffs[k] * Bp[sl]
        y = term if y is None else y + term
    return back(y)


def spmm_stencil(A: StencilMatrix, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for B of shape (*grid, k) — k right-hand sides at once.
    Flat (n, k) input is reshaped in/out for free (``_as_grid``)."""
    B, back = _as_grid(B, A.grid)
    halo = A.halo
    pad = [(h, h) for h in halo] + [(0, 0)]
    Bp = jnp.pad(B, pad)
    y = None
    for k, shift in enumerate(A.shifts):
        sl = tuple(
            slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid)
        ) + (slice(None),)
        term = A.data[k][..., None] * Bp[sl]
        y = term if y is None else y + term
    return back(y)
