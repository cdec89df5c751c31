"""Device-mesh helpers.

Replaces the reference's device-discovery runtime exports (``GetDeviceCount`` /
``SetDevice``, ``Mgcg/cuBlas/MgcgGpu/Runtime.cu:7-62``) — in JAX there are no
handles to create; a ``jax.sharding.Mesh`` over ``jax.devices()`` *is* the
communication topology, and XLA owns streams/queues.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(num_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (all by default).

    The reference's parallel solvers run on "however many devices exist"
    (``ConjugateGradientParallelGpu.cs:268``); same spirit here.  The axis is
    the row-block dimension; halos ride neighbor ``ppermute`` along it.
    """
    devices = jax.devices()
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(np.array(devices), (axis,))


def specs_for_grid(g, mesh, axes):
    """(data_spec, vector_spec) sharding the leading ``len(axes)`` grid axes
    that divide their mesh axes (NamedSharding requires even divisibility);
    non-divisible axes replicate.  The one divisibility rule shared by
    ``parallel.gspmd`` and ``precond.distributed``."""
    from jax.sharding import PartitionSpec as P

    names = []
    for i, ax_name in enumerate(tuple(axes)[: len(g)]):
        names.append(ax_name if g[i] % mesh.shape[ax_name] == 0 else None)
    if not any(names):
        return P(), P()
    tail = [None] * (len(g) - len(names))
    return P(None, *names, *tail), P(*names, *tail)


# ---------------------------------------------------------------------------
# Sharded-solver factory cache.
#
# The make_sharded_* factories close over STATIC structure only (offsets,
# sizes, policy, mesh) — the matrix data rides as a runtime argument — so a
# rebuilt factory re-traces an identical program.  The one-call conveniences
# (sharded_*_solve, the facade's mesh= routes) rebuild per call, which costs
# a full re-trace per solve; caching on the static key makes repeated
# facade solves hit the already-jitted program.  Entries whose key contains
# a fresh user callable (a per-call M_local lambda) simply miss — no worse
# than before.  Bounded LRU (same rationale as solvers/arnoldi.py).
# ---------------------------------------------------------------------------

import threading as _threading
from collections import OrderedDict as _OrderedDict

_FACTORY_CACHE: _OrderedDict = _OrderedDict()
_FACTORY_CAP = 64
_FACTORY_LOCK = _threading.Lock()


def _stable_key(key) -> bool:
    """A key is cacheable only if every callable in it has a stable identity
    (module-level functions).  Per-call lambdas/closures would insert
    never-hittable entries — polluting the LRU, evicting live programs and
    pinning dead compiled executables (review finding)."""
    for part in key:
        if callable(part):
            q = getattr(part, "__qualname__", "")
            if "<lambda>" in q or "<locals>" in q:
                return False
    return True


def factory_cache(key, build):
    """Return a cached factory product for ``key`` (all-hashable static
    config), building and inserting on miss.  Keys containing per-call
    callables (lambdas/closures) build fresh and stay uncached."""
    try:
        hash(key)
    except TypeError:  # unhashable component -> build fresh, uncached
        return build()
    if not _stable_key(key):
        return build()
    with _FACTORY_LOCK:
        hit = _FACTORY_CACHE.get(key)
        if hit is not None:
            _FACTORY_CACHE.move_to_end(key)
            return hit
    out = build()
    with _FACTORY_LOCK:
        _FACTORY_CACHE[key] = out
        _FACTORY_CACHE.move_to_end(key)
        while len(_FACTORY_CACHE) > _FACTORY_CAP:
            _FACTORY_CACHE.popitem(last=False)
    return out
