"""Halo exchange and per-shard SpMV — the communication backend.

The reference's halo exchange stages boundary slices of the search-direction
vector device->host->device through pinned .NET arrays, one neighbor pair at a
time (``P2Host``/``P2Device`` ``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:88-113``,
orchestrated by ``SyncP`` ``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:384-419``;
fixed-band variant ``Mgcg/HandmadeCL/MgcgCL/ConjugateGradientParallelGpu.cs:426-441``).

Here the same data motion is two ``jax.lax.ppermute`` neighbor shifts over
ICI/DCN *inside* the jitted SPMD program: no host staging, no thread barriers,
and XLA's scheduler is free to overlap the shift with interior compute.  The
halo width is the matrix bandwidth — static metadata — so the exchanged slices
are compile-time-shaped, the moral equivalent of the reference discovering
exact ``minJ``/``maxJ`` ranges at init (``Mgcg.cu:82-84``) rather than moving
the whole vector.

Ring wraparound note: ``ppermute`` is cyclic, so the first/last shards receive
wrapped data in their halos.  This is *correct by construction*: DIA stores
structural zeros wherever ``i + offset`` exits the global index range, so
wrapped halo values are always multiplied by zero (tested in
``tests/test_parallel.py::test_wraparound_halo_is_masked``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def halo_exchange(p: jnp.ndarray, halo: int, axis: str, num_shards: int) -> jnp.ndarray:
    """Return p padded with its neighbors' boundary slices.

    ``p`` is this shard's (n_local,) slice; the result is
    (n_local + 2*halo,): [left neighbor's tail | p | right neighbor's head].
    """
    if halo == 0:
        return p
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]  # send right
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]  # send left
    left_halo = jax.lax.ppermute(p[-halo:], axis, fwd)  # receive left nbr's tail
    right_halo = jax.lax.ppermute(p[:halo], axis, bwd)  # receive right nbr's head
    return jnp.concatenate([left_halo, p, right_halo])


def spmv_dia_local(
    data_local: jnp.ndarray,
    offsets: Tuple[int, ...],
    p_padded: jnp.ndarray,
    halo: int,
) -> jnp.ndarray:
    """Local rows of y = A p from halo-padded p.

    ``data_local`` is (ndiags, n_local) — this shard's rows of the global DIA
    data (row-indexed, so no rebasing needed; the reference instead rebases CSR
    row pointers by elementOffset, ``Mgcg.cu:73``).  ``p_padded`` is
    (n_local + 2*halo,).  For local row i (global row offset+i):
    y[i] = sum_k data[k, i] * p_global[offset + i + off] and
    p_global[offset + i + off] == p_padded[halo + i + off] since
    |off| <= halo.
    """
    n_local = data_local.shape[1]
    y = jnp.zeros(n_local, dtype=jnp.result_type(data_local.dtype, p_padded.dtype))
    for k, off in enumerate(offsets):
        y = y + data_local[k] * jax.lax.dynamic_slice(p_padded, (halo + off,), (n_local,))
    return y


def exchange_halos(p: jnp.ndarray, halo: int, axis: str, num_shards: int):
    """The two neighbor slices only (not concatenated) — returned separately
    so callers can keep interior compute independent of the communication."""
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    left_halo = jax.lax.ppermute(p[-halo:], axis, fwd)
    right_halo = jax.lax.ppermute(p[:halo], axis, bwd)
    return left_halo, right_halo


def spmv_dia_local_overlap(
    data_local: jnp.ndarray,
    offsets: Tuple[int, ...],
    p: jnp.ndarray,
    halo: int,
    axis: str,
    num_shards: int,
) -> jnp.ndarray:
    """Halo-overlap SpMV: communication rides under the interior compute.

    The reference's halo exchange is fully synchronous — ``SyncP`` completes
    before any SpMV work starts (``ConjugateGradientParallelGpu.cs:427,469``).
    Here the dependency structure *tells* XLA's latency-hiding scheduler what
    can overlap: interior rows ``[halo, n_local - halo)`` read only local
    ``p``, so their (dominant) compute has no data dependence on the
    ``ppermute``; only the 2*halo boundary rows wait for neighbor data.  This
    is the async upgrade SURVEY.md §7 lists as hard part 6, expressed purely
    through dataflow — no manual double-buffering.
    """
    n_local = data_local.shape[1]
    if halo == 0 or 2 * halo >= n_local:
        return spmv_dia_local(data_local, offsets, halo_exchange(p, halo, axis, num_shards), halo)

    left_halo, right_halo = exchange_halos(p, halo, axis, num_shards)

    # interior rows: depend on local p only — overlappable with the permutes
    p_loc = jnp.pad(p, (halo, halo))  # zero pad; interior rows never read the pads
    y_int = jnp.zeros(n_local, dtype=jnp.result_type(data_local.dtype, p.dtype))
    for k, off in enumerate(offsets):
        y_int = y_int + data_local[k] * jax.lax.dynamic_slice(p_loc, (halo + off,), (n_local,))

    # boundary rows: the only consumers of the received halos
    head = jnp.concatenate([left_halo, p[: 2 * halo]])  # covers rows [0, halo)
    tail = jnp.concatenate([p[-2 * halo :], right_halo])  # covers rows [n-halo, n)
    y_head = jnp.zeros(halo, dtype=y_int.dtype)
    y_tail = jnp.zeros(halo, dtype=y_int.dtype)
    for k, off in enumerate(offsets):
        y_head = y_head + data_local[k, :halo] * jax.lax.dynamic_slice(head, (halo + off,), (halo,))
        y_tail = y_tail + data_local[k, n_local - halo :] * jax.lax.dynamic_slice(
            tail, (halo + off,), (halo,)
        )
    return jnp.concatenate([y_head, y_int[halo : n_local - halo], y_tail])


def extend_dia_data(
    data_local: jnp.ndarray, H: int, axis: str, num_shards: int
) -> jnp.ndarray:
    """(ndiags, n_local + 2H) DIA data extended with the neighbors' boundary
    ROWS — the static half of the matrix-powers kernel (exchanged ONCE per
    solve; the matrix does not change across iterations)."""
    if H == 0:
        return data_local
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    left = jax.lax.ppermute(data_local[:, -H:], axis, fwd)
    right = jax.lax.ppermute(data_local[:, :H], axis, bwd)
    return jnp.concatenate([left, data_local, right], axis=1)


def dia_basis_powers(
    data_ext: jnp.ndarray,
    offsets: Tuple[int, ...],
    p: jnp.ndarray,
    r: jnp.ndarray,
    s: int,
    halo: int,
    axis: str,
    num_shards: int,
) -> jnp.ndarray:
    """The MATRIX-POWERS KERNEL: the (2s+1, n_local) CA-CG basis rows
    ``[p, Ap, ..., A^s p, r, Ar, ..., A^{s-1} r]`` from ONE fused widened
    halo exchange (2 ``ppermute`` messages total, width H = s*halo each)
    instead of 2s-1 per-SpMV exchanges (4s-2 messages).

    How: with the DIA data pre-extended by the neighbors' H boundary rows
    (``extend_dia_data``, once per solve), each local application of A on
    the (n_local + 2H)-extended vector is exact on a region that SHRINKS by
    ``halo`` rows per application — after j <= s applications the center
    n_local rows are still exact, which is all the basis stores.  Global
    -edge wraparound stays correct by the structural-zero invariant: any
    consumption of an out-of-range column goes through a TRUE row's leg
    whose DIA entry is structurally zero, so wrapped garbage is multiplied
    away at every power (same argument as the one-hop halo, extended
    inductively).  Requires H <= n_local (one-hop reach).
    """
    n_local = p.shape[0]
    H = s * halo
    dtype = jnp.result_type(data_ext.dtype, p.dtype)
    # ONE fused exchange: both vectors' boundary slabs ride one message pair
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    tails = jnp.stack([p[-H:], r[-H:]])
    heads = jnp.stack([p[:H], r[:H]])
    lefts = jax.lax.ppermute(tails, axis, fwd)
    rights = jax.lax.ppermute(heads, axis, bwd)
    p_ext = jnp.concatenate([lefts[0], p, rights[0]])
    r_ext = jnp.concatenate([lefts[1], r, rights[1]])

    L = n_local + 2 * H

    def apply_ext(v_ext):
        vp = jnp.pad(v_ext, (halo, halo))
        y = jnp.zeros(L, dtype)
        for k, off in enumerate(offsets):
            y = y + data_ext[k] * jax.lax.dynamic_slice(vp, (halo + off,), (L,))
        return y

    def powers(v_ext, k):
        rows = [v_ext[H : H + n_local]]
        cur = v_ext
        for _ in range(k):
            cur = apply_ext(cur)
            rows.append(cur[H : H + n_local])
        return rows

    return jnp.stack(powers(p_ext, s) + powers(r_ext, s - 1))


def ring_gather(p: jnp.ndarray, hops: int, axis: str, num_shards: int) -> jnp.ndarray:
    """Multi-hop block collection: ``[p from shard i-hops | ... | p | ... |
    p from shard i+hops]`` — shape ``((2*hops+1) * n_local,)``.

    The generalisation of ``halo_exchange`` for exact column windows that span
    several neighbor shards (the reference's ``minJ``/``maxJ`` ranges,
    ``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:82-84``, whose window is *not* bounded by
    one shard when the matrix is wide or the shards are small).  Each hop is
    one cyclic ``ppermute`` in each direction; consumers index the result as
    ``global_col - (shard_offset - hops * n_local)``.  Ring wraparound at the
    global edges is harmless exactly when the consumer's indices only target
    columns within ``hops`` shards of the owner — guaranteed by construction
    when ``hops`` comes from ``core.partition.halo_hops``.
    """
    if hops == 0:
        return p
    fwd = [(i, (i + 1) % num_shards) for i in range(num_shards)]
    bwd = [(i, (i - 1) % num_shards) for i in range(num_shards)]
    lefts, rights = [], []
    cl = cr = p
    for _ in range(hops):
        cl = jax.lax.ppermute(cl, axis, fwd)  # after h hops: p of shard i-h
        cr = jax.lax.ppermute(cr, axis, bwd)  # after h hops: p of shard i+h
        lefts.append(cl)
        rights.append(cr)
    return jnp.concatenate(list(reversed(lefts)) + [p] + rights)


def spmv_dia_allgather(
    data_local: jnp.ndarray,
    offsets: Tuple[int, ...],
    p: jnp.ndarray,
    axis: str,
    num_shards: int,
) -> jnp.ndarray:
    """All-gather fallback SpMV for ``bandwidth > n_local``.

    The reference's implicit worst case: ``vectorP`` is allocated global
    length on every device (``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:321``)
    so any shard can read any column.  Here the global vector is materialised
    per shard by one ``all_gather`` over the mesh axis and the local rows are
    computed from statically-shifted slices of it — O(n) comms per iteration
    instead of O(halo), which is exactly why the halo path is preferred
    whenever ``bandwidth <= n_local`` (``make_sharded_cg`` auto-selects).
    """
    n_local = data_local.shape[1]
    p_g = jax.lax.all_gather(p, axis, tiled=True)  # (n,)
    B = max((abs(o) for o in offsets), default=0)
    xpad = jnp.pad(p_g, (B, B))
    row0 = jax.lax.axis_index(axis) * n_local  # this shard's first global row
    y = jnp.zeros(n_local, dtype=jnp.result_type(data_local.dtype, p.dtype))
    for k, off in enumerate(offsets):
        y = y + data_local[k] * jax.lax.dynamic_slice(xpad, (row0 + B + off,), (n_local,))
    return y
