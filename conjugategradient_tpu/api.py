"""High-level one-call API: ``solve(A, b, method=...)``.

The reference's user workflow is ``Initialize() / Solve() / Read()`` on a
hand-picked backend class (``Mgcg/cuBlas/Mgcg/ConjugateGradientGpu.cs:84-89``);
here one function routes to the right solver:

- ``method="cg"``     — device-resident plain CG
- ``method="jacobi_cg"`` — point-Jacobi PCG
- ``method="cheb_cg"`` — Chebyshev-polynomial PCG (``degree=`` through kw;
  bounds estimated by Lanczos at setup) — for matrices with no grid to
  hang a multigrid on
- ``method="mgcg"``   — multigrid-preconditioned CG (needs ``grid``)
- ``method="refined"``— mixed-precision iterative refinement to fp64 tol
  (``device_residual=True`` keeps the outer loop on the device in double-float)
- ``method="deflated_cg"`` — def-CG with a Lanczos-probed deflation space
  (``k=``/``m=`` or a prebuilt ``deflation=`` for solve sequences)
- ``method="sharded_cg"`` — row-block-sharded CG over the device mesh
  (DIA → halo-exchange solver; CSR/ELL → exact-halo-range solver); pass
  ``mesh=``/``variant=``/``M_local=`` through ``**kw``
- ``method="bicgstab"`` / ``"jacobi_bicgstab"`` — nonsymmetric systems,
  short recurrence (``solvers.bicgstab``); with ``mesh=`` the row-block-
  sharded form (``parallel.shard_nonsym``, 2 collectives/iteration)
- ``method="gmres"`` / ``"jacobi_gmres"`` — nonsymmetric systems, restarted
  GMRES (``restart=`` through kw; ``solvers.gmres``); with ``mesh=`` the
  sharded form (row-sharded Arnoldi basis, one psum per CGS2 pass)
- ``method="mg_bicgstab"`` / ``"mg_gmres"`` — multigrid-preconditioned
  nonsymmetric solves (needs ``grid=``): the MGCG hierarchy as a right
  preconditioner (70-150x measured iteration cuts on convection-diffusion)
- ``method="fgmres"`` — FLEXIBLE GMRES: the preconditioner may be nonlinear
  / iteration-varying.  ``inner="bicgstab"|"cg"|"chebyshev"`` (+
  ``inner_iterations=``) installs a fixed-budget inner Krylov solve as the
  preconditioner (inner-outer composition); prefixes compose — e.g.
  ``method="mg_fgmres", inner="bicgstab"`` preconditions the INNER solve
  with the V-cycle.  ``mesh=`` routes to the row-sharded form
- ``method="amg_cg"`` / ``"amg_minres"`` / ``"amg_bicgstab"`` /
  ``"amg_gmres"`` — ALGEBRAIC (smoothed-aggregation) multigrid, no grid
  required: the MGCG-strength preconditioner for Matrix Market / permuted /
  unstructured matrices (``theta=``/``near_null=`` through kw;
  ``precond.amg``); nonsymmetric bases build it on the symmetric part.
  ``mesh=`` routes to the distributed carrier (``parallel.shard_amg``:
  row-sharded SA levels, exact-hop ring gathers, replicated coarse tail)
- ``method="bjacobi_cg"`` / ``"bjacobi_bicgstab"`` / ``"bjacobi_gmres"`` —
  block-Jacobi preconditioning (``block_size=`` through kw; batched dense
  block inverses, one batched matmul per application)
- ``method="minres"`` / ``"jacobi_minres"`` — symmetric INDEFINITE systems
  (Helmholtz); constant memory, monotone ``||r||`` (``solvers.minres``)
- ``method="idr"`` — IDR(s) for nonsymmetric systems (``s=`` through kw,
  default 4): finite-termination Sonneveld-subspace recurrence between
  BiCGStab (memory) and GMRES (robustness); prefixes compose
  (``jacobi_``/``bjacobi_``/``mg_``/``amg_``); ``mesh=`` routes to the
  row-sharded form (``solvers.idr``, ``parallel.shard_nonsym``)
- ``method="lsmr"`` — least squares ``min ||A x - b||`` for RECTANGULAR
  (over/underdetermined) A, with optional Tikhonov ``damp=`` (ridge);
  Golub-Kahan + double QR, monotone ``||A^T r||`` (``solvers.lsmr``)
- ``method="cgnr"`` — CG on the normal equations (any nonsingular A;
  constant memory, kappa squared — the nonsymmetric fallback)
- ``method="chebyshev"`` — dot-free Chebyshev iteration for SPD systems
  (``bounds=(lo, hi)``, ``check_every=``); with ``mesh=``: ONE all-reduce
  per check_every iterations (``solvers.cheby``)
- ``method="cacg"`` / ``"jacobi_cacg"`` — s-step communication-avoiding CG
  (``s=`` through kw, default 4): CG's own optimality at ONE fused Gram
  reduction per s iterations — no spectral bounds needed, ~2x the SpMV
  work; with ``mesh=`` the row-block-sharded form (matrix-powers halo
  kernel + block-boundary residual replacement: 2 all-reduces + 4
  permutes per s iterations, HLO-audited).  ``jacobi_`` = symmetric
  diagonal scaling folded into the operator (the only preconditioning
  form the s-step shift identity admits); l2/rel_l2 norms, monitored in
  the scaled system when prefixed
- ``method="auto"`` — probe the matrix (shape, symmetry, definiteness)
  and pick: LSMR for rectangular, CG/MGCG for SPD, MINRES for symmetric
  indefinite, BiCGStab (mg_ with a grid) for nonsymmetric
- ``method="oracle"`` — fp64 numpy CPU oracle
- ``method="native"`` — C++ OpenMP CPU solver

Accepts any storage format; host numpy arrays in, ``CGResult``-like out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from conjugategradient_tpu.core import formats, oracle
from conjugategradient_tpu.core.formats import DiaMatrix
from conjugategradient_tpu.solvers.policy import ConvergencePolicy


def _jacobi_M_local(r, aux):
    """Shard-local point-Jacobi application.  MODULE-LEVEL on purpose: its
    identity enters the sharded-factory cache key (parallel.mesh.
    factory_cache), and a per-call lambda would defeat the cache — every
    facade jacobi_* mesh= solve would re-trace."""
    return aux * r


def solve(
    A,
    b,
    x0=None,
    method: str = "cg",
    tol: float = 1e-8,
    norm: str = "l2",
    min_iteration: int = 0,
    max_iteration: Optional[int] = None,
    grid: Optional[Tuple[int, ...]] = None,
    dtype=None,
    **kw,
):
    """Solve A x = b.  Returns an object with ``.x``, ``.iterations``,
    ``.residual``, ``.converged`` (device or host depending on method)."""
    policy = ConvergencePolicy(
        tol=tol, norm=norm, min_iteration=min_iteration, max_iteration=max_iteration
    )
    if method == "auto":
        shape = getattr(A, "shape", None)
        if shape is not None and shape[0] != shape[1]:
            # rectangular: the only well-posed ask is least squares
            method = "lsmr"
        else:
            method = _auto_method(A, grid)
        if method == "idr" and np.asarray(b).ndim == 2:
            # the (n, k) block carriers have no IDR form; block BiCGStab is
            # the multi-RHS route (its per-column recurrences + the stall
            # warning below cover the robustness gap honestly)
            method = "bicgstab"
        # auto owns the outcome: if the chosen route exhausts its budget,
        # surface a stall DIAGNOSIS (host-side warning), not just the
        # converged=False flag — the measured failure mode is an fp32
        # Krylov floor above the requested tol, and the cure is a
        # preconditioner or mixed-precision refinement, not more iterations
        res = solve(
            A, b, x0, method=method, tol=tol, norm=norm,
            min_iteration=min_iteration, max_iteration=max_iteration,
            grid=grid, dtype=dtype, **kw,
        )
        conv = np.asarray(getattr(res, "converged", True))
        if not bool(conv.all()):
            import warnings

            resid = np.asarray(res.residual)
            its = np.asarray(res.iterations)
            warnings.warn(
                f"auto-dispatched method={method!r} stalled at residual "
                f"{float(resid.max()):.3e} (tol {tol:.1e}, "
                f"{int(its.max())} iterations"
                + (f", {int(conv.sum())}/{conv.size} columns converged"
                   if conv.size > 1 else "")
                + "). Likely an fp32 attainable-accuracy floor. Try: a "
                "preconditioned route (grid= for mg_*, amg_* for no grid), "
                "method='refined' (fp64-tolerance mixed-precision "
                "refinement), or fp64 on CPU.",
                RuntimeWarning,
                stacklevel=2,
            )
        return res
    if np.asarray(b).ndim == 2:
        # (n, k) right-hand sides: route to the block solver (one matrix
        # pass serves k Krylov recurrences; see solvers.multi).  BEFORE the
        # 1-D mesh aliasing below — _solve_multi has its own mesh routing
        # and the alias would smuggle M_local/M_aux kwargs the block
        # carriers do not take (review finding)
        return _solve_multi(A, b, x0, method, policy, grid, dtype, **kw)
    # mesh-aware aliasing: cg/jacobi_cg/mgcg with mesh= route to their
    # distributed carriers (auto resolves to these names, and the
    # single-device solvers take no mesh kw)
    if "mesh" in kw:
        if method == "cg":
            method = "sharded_cg"
        elif method == "jacobi_cg":
            kw.setdefault("M_local", _jacobi_M_local)
            kw.setdefault("M_aux", 1.0 / _diagonal(A))
            method = "sharded_cg"
    if method == "oracle":
        return oracle.cg(
            A, b, x0, tol=tol, norm=norm, min_iteration=min_iteration,
            max_iteration=max_iteration, raise_on_divergence=False,
        )
    if method == "native":
        from conjugategradient_tpu import native

        csr = A if isinstance(A, formats.CsrMatrix) else _to_csr(A)
        return native.cg(
            csr, b, x0, tol=tol, norm=norm, min_iteration=min_iteration,
            max_iteration=max_iteration, raise_on_divergence=False,
        )
    if method == "refined":
        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        if "mesh" in kw or "axes" in kw:
            # mesh-partitioned refinement: dd outer pass + GSPMD MGCG inner
            from conjugategradient_tpu.parallel.gspmd import gspmd_refined_solve

            if grid is None:
                raise TypeError("refined solve over a mesh requires grid=")
            return gspmd_refined_solve(
                A, b, grid, x0=x0, tol=tol, norm=norm, **kw
            )
        from conjugategradient_tpu.solvers.refine import refined_solve

        return refined_solve(A, b, x0, tol=tol, norm=norm, grid=grid, **kw)
    if method == "deflated_cg":
        import jax.numpy as jnp

        from conjugategradient_tpu.solvers.deflation import (
            deflated_cg_solve,
            make_deflation,
        )

        deflation = kw.pop("deflation", None)
        if deflation is None:
            deflation = make_deflation(
                A, k=int(kw.pop("k", 8)), m=kw.pop("m", None),
                dtype=dtype or np.asarray(b).dtype,
            )
        A_dev = A.device_put(dtype=dtype) if hasattr(A, "device_put") else A
        b_dev = jnp.asarray(np.asarray(b), dtype=dtype)
        x0_dev = None if x0 is None else jnp.asarray(np.asarray(x0), dtype=dtype)
        return deflated_cg_solve(
            A_dev, b_dev, x0_dev, policy=policy, deflation=deflation, **kw
        )
    if method == "sharded_cg":
        if isinstance(A, DiaMatrix):
            from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve

            return sharded_cg_solve(A, b, x0, policy, dtype=dtype, **kw)
        if isinstance(A, (formats.CsrMatrix, formats.EllMatrix)):
            from conjugategradient_tpu.parallel.sharded_general import (
                sharded_cg_solve_general,
            )

            return sharded_cg_solve_general(A, b, x0, policy, dtype=dtype, **kw)
        raise TypeError("sharded_cg requires a DiaMatrix, CsrMatrix or EllMatrix")
    if method == "mgcg":
        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        if "mesh" in kw:
            # distributed MGCG: the GSPMD carrier (handles the odd fw grids
            # by replication; even grids partition — cf. gspmd_mg_nonsym)
            from conjugategradient_tpu.core.generators import LinearSystem
            from conjugategradient_tpu.parallel.gspmd import gspmd_mgcg_solve

            n = A.n
            x0_arr = np.zeros(n) if x0 is None else np.asarray(x0)
            system = LinearSystem(A, np.asarray(b), x0_arr)
            return gspmd_mgcg_solve(
                system, grid, policy=policy, dtype=dtype, **kw
            )
        from conjugategradient_tpu.precond import mgcg_solve

        res, _ = mgcg_solve(A, b, grid, x0=x0, policy=policy, **kw)
        return res

    import jax.numpy as jnp

    from conjugategradient_tpu.solvers.cg import cg_solve

    # split a preconditioner prefix off the method name; M construction is
    # DEFERRED until the route is known (the sharded paths place the matrix
    # themselves, and must not pay for a hierarchy they cannot use)
    prefix = None
    base = method
    for p in ("jacobi_", "bjacobi_", "amg_", "mg_"):
        if method.startswith(p):
            prefix, base = p[:-1], method[len(p):]
            break

    if base == "chebyshev" and prefix is not None:
        raise ValueError(
            "chebyshev takes no preconditioner prefix (fold scaling into "
            "the operator and its bounds instead)"
        )
    if base == "cacg":
        if prefix not in (None, "jacobi"):
            raise ValueError(
                f"{method}: cacg supports only the jacobi_ prefix (symmetric "
                "diagonal scaling — a general M breaks the s-step shift "
                "identity; use cg/cg1 for those)"
            )
        import dataclasses

        A_c, dis, b_c, x0_c = A, None, b, x0
        if prefix == "jacobi":
            # D^{-1/2} A D^{-1/2} y = D^{-1/2} b; x = D^{-1/2} y — the
            # residual/tolerance is monitored in the SCALED system
            if not isinstance(A, DiaMatrix):
                raise TypeError("jacobi_cacg requires a DiaMatrix")
            A_c, dis = formats.jacobi_scaled_dia(A)
            b_c = np.asarray(b) * dis
            x0_c = None if x0 is None else np.asarray(x0) / dis
        if "mesh" in kw:
            if not isinstance(A_c, DiaMatrix):
                raise TypeError(
                    "cacg with mesh= requires a DiaMatrix (the matrix-powers "
                    "halo kernel is banded-DIA); convert or use "
                    "method='sharded_cg'"
                )
            from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve

            res = sharded_cg_solve(
                A_c, b_c, x0_c, policy, dtype=dtype, variant="cacg", **kw
            )
        else:
            from conjugategradient_tpu.solvers.cacg import cacg_solve

            A_cd = A_c.device_put(dtype=dtype) if hasattr(A_c, "device_put") else A_c
            res = cacg_solve(
                A_cd, jnp.asarray(np.asarray(b_c), dtype=dtype),
                None if x0_c is None else jnp.asarray(np.asarray(x0_c), dtype=dtype),
                policy, **kw,
            )
        if dis is not None:
            res = dataclasses.replace(
                res, x=res.x * jnp.asarray(dis, res.x.dtype)
            )
        return res
    if prefix == "amg" and "mesh" in kw:
        # distributed algebraic multigrid: row-sharded SA levels with exact
        # -hop ring gathers (all-gather fallback), replicated coarse tail —
        # the V-cycle rides the sharded Krylov loops as M inside one
        # shard_map program (parallel.shard_amg)
        if base not in ("cg", "bicgstab", "gmres", "fgmres", "minres"):
            raise ValueError(f"{method} with mesh= is not supported")
        from conjugategradient_tpu.parallel.shard_amg import sharded_amg_solve

        res, _h = sharded_amg_solve(
            A, b, x0, policy, method=base, mesh=kw.pop("mesh"),
            dtype=dtype, **kw,
        )
        return res
    if base in ("bicgstab", "gmres", "fgmres", "minres", "chebyshev", "idr") and "mesh" in kw:
        # row-block-sharded nonsymmetric solve; only shard-equivariant
        # preconditioning is available (jacobi_ becomes the M_local form —
        # mg_/bjacobi_ would be silently replaced, so they are refused)
        from conjugategradient_tpu.parallel.shard_nonsym import sharded_nonsym_solve

        if prefix == "mg":
            # distributed multigrid-preconditioned nonsym solve: the GSPMD
            # carrier (V-cycle + Krylov loop partitioned as one program) —
            # the explicit shard_map path's even-extent constraint excludes
            # the odd fw grids rediscretized hierarchies live on
            if base not in ("bicgstab", "gmres", "fgmres", "idr"):
                raise ValueError(f"{method} with mesh= is not supported")

            if grid is None:
                raise ValueError(f"{method} requires grid=")
            if not isinstance(A, DiaMatrix):
                raise TypeError(f"{method} requires a DiaMatrix")
            from conjugategradient_tpu.parallel.gspmd import gspmd_mg_nonsym_solve

            return gspmd_mg_nonsym_solve(
                A, b, grid, mesh=kw.pop("mesh"), policy=policy, method=base,
                x0=x0, dtype=dtype,
                coarse_operator=kw.pop("coarse_operator", None), **kw,
            )
        if base == "fgmres" and "inner" in kw:
            raise ValueError(
                "fgmres with mesh= does not take inner=: a global inner "
                "Krylov solve needs its own collectives; pass a shard-local "
                "fixed-budget M_local to "
                "parallel.shard_nonsym.sharded_nonsym_solve instead"
            )
        mkw = {}
        if prefix == "jacobi":
            mkw = dict(M_local=_jacobi_M_local, M_aux=1.0 / _diagonal(A))
        elif prefix == "bjacobi":
            # shard-local when blocks never cross shard boundaries
            from conjugategradient_tpu.precond.block_jacobi import (
                block_jacobi_M_local,
                block_jacobi_aux,
            )

            bs = int(kw.pop("block_size", 8))
            mesh_obj = kw["mesh"]
            axis0 = kw.get("axis", "x")
            n_local = A.n // mesh_obj.shape[axis0]
            if n_local % bs:
                raise ValueError(
                    f"bjacobi with mesh= needs block_size ({bs}) to divide "
                    f"the shard length ({n_local}) so blocks stay shard-local"
                )
            mkw = dict(
                M_local=block_jacobi_M_local, M_aux=block_jacobi_aux(A, bs)
            )
        if base == "chebyshev" and "bounds" not in kw:
            from conjugategradient_tpu.solvers.cheby import estimate_bounds

            kw["bounds"] = estimate_bounds(A)
        return sharded_nonsym_solve(
            A, b, x0, policy, method=base, dtype=dtype, **mkw, **kw
        )
    if method == "lsmr" and "mesh" in kw:
        # distributed least squares: A and A^T halo SpMVs + two scalar
        # psums (the Golub-Kahan beta/alpha norms) per iteration.
        # Rectangular systems must be square-padded by the caller first
        # (zero rows/columns are exactly neutral in the LSMR recurrence);
        # the sharded path needs the square-banded DIA layout.
        from conjugategradient_tpu.parallel.shard_nonsym import sharded_lsmr_solve

        if not isinstance(A, DiaMatrix):
            raise TypeError(
                "lsmr with mesh= needs a square-banded DiaMatrix "
                "(rectangular input: embed it in a square band — zero "
                "rows/columns are neutral in LSMR — or solve unsharded)"
            )
        return sharded_lsmr_solve(
            A, b, x0, policy, mesh=kw.pop("mesh"), dtype=dtype, **kw
        )
    # device placement happens only after every mesh-routed branch has
    # had its chance to return (those place b themselves; a premature
    # device_put is a wasted full-size H2D copy at rung-5 sizes)
    b_dev = jnp.asarray(np.asarray(b), dtype=dtype)
    x0_dev = None if x0 is None else jnp.asarray(np.asarray(x0), dtype=dtype)

    if method == "cgnr":
        from conjugategradient_tpu.solvers.cgnr import cgnr_solve

        return cgnr_solve(A, b_dev, x0_dev, policy, **kw)
    if method == "lsmr":
        from conjugategradient_tpu.solvers.lsmr import lsmr_solve

        return lsmr_solve(A, b_dev, x0_dev, policy, **kw)

    A_dev = A.device_put(dtype=dtype) if hasattr(A, "device_put") else A
    M = None
    if prefix == "jacobi":
        from conjugategradient_tpu.precond import jacobi_preconditioner

        diag = _diagonal(A)
        M = jacobi_preconditioner(jnp.asarray((1.0 / diag), dtype=b_dev.dtype))
        method = base
    elif prefix == "bjacobi":
        from conjugategradient_tpu.precond import block_jacobi_preconditioner

        M = block_jacobi_preconditioner(
            A, int(kw.pop("block_size", 8)), dtype=b_dev.dtype
        )
        method = base
    elif prefix == "mg":
        # multigrid-preconditioned nonsymmetric solve: the same Galerkin
        # hierarchy/V-cycle as MGCG, applied as a right preconditioner
        # (measured: 1100 -> 16 BiCGStab its on 63x63 convection-diffusion
        # at eps=0.01 — the smooth error modes are still multigrid's)
        from conjugategradient_tpu.precond import as_preconditioner, build_hierarchy

        if grid is None:
            raise ValueError(f"{method} requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError(f"{method} requires a DiaMatrix")
        # coarse_operator= (rediscretization hook): REQUIRED for stability
        # on convection-dominated operators past ~127^2 — Galerkin-of-upwind
        # coarse operators amplify (see generators.
        # convection_diffusion_coarse_operator); harmless to omit for
        # diffusion-dominated systems
        h = build_hierarchy(
            A, grid, dtype=np.dtype(b_dev.dtype),
            coarse_operator=kw.pop("coarse_operator", None),
        )
        M = as_preconditioner(h)
        method = base
    elif prefix == "amg":
        # algebraic (smoothed-aggregation) multigrid: no grid needed — the
        # MGCG-strength preconditioner for Matrix Market / permuted /
        # unstructured matrices.  Nonsymmetric bases build the hierarchy on
        # A itself with Jacobi smoothing and apply it on the right: measured
        # 660 -> 12 BiCGStab its on 63x63 convection-diffusion at eps=0.1,
        # where the symmetric-part hierarchy only reached 221 (the coarse
        # correction must see the convection) and Chebyshev smoothing
        # DIVERGED (it assumes a real positive D^{-1}A spectrum).
        from conjugategradient_tpu.precond import amg_preconditioner, build_amg_hierarchy

        setup_kw = {
            k: kw.pop(k)
            for k in ("theta", "near_null", "max_coarse", "max_levels")
            if k in kw
        }
        if base in ("bicgstab", "gmres", "fgmres", "idr"):
            setup_kw.setdefault("smoother", "jacobi")
        h = build_amg_hierarchy(A, dtype=np.dtype(b_dev.dtype), **setup_kw)
        M = amg_preconditioner(h)
        method = base
    elif method == "cheb_cg":
        from conjugategradient_tpu.precond import chebyshev_preconditioner_for

        # reuse the already-placed matrix and solve at b's dtype: one device
        # copy, M applications dtype-consistent with the CG state
        M, _ = chebyshev_preconditioner_for(
            A, degree=int(kw.pop("degree", 3)), A_dev=A_dev, dtype=b_dev.dtype
        )
        method = "cg"
    if method == "bicgstab":
        from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve

        return bicgstab_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)
    if method == "idr":
        from conjugategradient_tpu.solvers.idr import idr_solve

        return idr_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)
    if method == "minres":
        from conjugategradient_tpu.solvers.minres import minres_solve

        return minres_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)
    if method == "gmres":
        from conjugategradient_tpu.solvers.gmres import gmres_solve

        return gmres_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)
    if method == "fgmres":
        from conjugategradient_tpu.solvers.gmres import (
            fgmres_solve,
            inner_solve_preconditioner,
        )

        inner = kw.pop("inner", None)
        if inner is not None:
            # inner-outer Krylov: the prefix-built M (V-cycle, Jacobi, ...)
            # preconditions the INNER solve; FGMRES sees the composed,
            # nonlinear fixed-budget map
            M = inner_solve_preconditioner(
                A_dev, method=inner,
                iterations=int(kw.pop("inner_iterations", 8)), M=M,
            )
        return fgmres_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)
    if method == "chebyshev":
        from conjugategradient_tpu.solvers.cheby import chebyshev_solve

        if "bounds" not in kw:
            from conjugategradient_tpu.solvers.cheby import estimate_bounds

            kw["bounds"] = estimate_bounds(A)
        return chebyshev_solve(A_dev, b_dev, x0_dev, policy, **kw)
    if method != "cg":
        raise ValueError(f"unknown method {method!r}")
    return cg_solve(A_dev, b_dev, x0_dev, policy, M=M, **kw)


def _solve_multi(A, B, X0, method, policy, grid, dtype, **kw):
    """Multi-RHS facade routing: cg / jacobi_cg / bjacobi_cg / mgcg /
    amg_cg / refined and the bicgstab family (plain / jacobi_ / bjacobi_ /
    mg_ / amg_) over (n, k) blocks."""
    import jax.numpy as jnp

    from conjugategradient_tpu.solvers.multi import (
        as_multi_preconditioner,
        cg_solve_multi,
    )

    if method == "refined":
        from conjugategradient_tpu.solvers.refine import refined_solve_multi

        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        return refined_solve_multi(
            A, B, X0, tol=policy.tol, norm=policy.norm, grid=grid, **kw
        )

    if "mesh" in kw:
        # distributed (n, k) blocks: flat-band sharded block CG/BiCGStab
        # (one ppermute pair + one (k,)-psum per dot regardless of k) and
        # the explicit shard_map multi-RHS MGCG
        mesh = kw.pop("mesh")
        if method in ("sharded_cg", "cg", "bicgstab"):
            from conjugategradient_tpu.parallel.shard_multi import (
                sharded_cg_multi_solve,
            )

            return sharded_cg_multi_solve(
                A, B, X0, policy, mesh=mesh, dtype=dtype,
                method="bicgstab" if method == "bicgstab" else "cg", **kw,
            )
        if method == "mgcg":
            from conjugategradient_tpu.core.generators import LinearSystem
            from conjugategradient_tpu.parallel.shard_multi import (
                shard_multi_mgcg_solve,
            )

            if grid is None:
                raise ValueError("mgcg requires grid=")
            if not isinstance(A, DiaMatrix):
                raise TypeError("mgcg requires a DiaMatrix")
            system = LinearSystem(A, np.zeros(A.n), np.zeros(A.n))
            return shard_multi_mgcg_solve(
                system, np.asarray(B), grid, mesh=mesh, policy=policy,
                dtype=dtype, X0=X0, **kw,
            )
        raise ValueError(
            f"method {method!r} with mesh= does not support (n, k) "
            "right-hand sides; use cg/bicgstab/mgcg or solve columns "
            "separately"
        )

    A_dev = A.device_put(dtype=dtype) if hasattr(A, "device_put") else A
    B_dev = jnp.asarray(np.asarray(B), dtype=dtype)
    X0_dev = None if X0 is None else jnp.asarray(np.asarray(X0), dtype=dtype)
    M = None
    if method == "jacobi_cg":
        inv = jnp.asarray(1.0 / _diagonal(A), dtype=B_dev.dtype)
        M = lambda R: inv[:, None] * R
    elif method == "bjacobi_cg":
        from conjugategradient_tpu.precond import block_jacobi_preconditioner

        # the block-Jacobi apply is shape-agnostic over the trailing axis
        M = block_jacobi_preconditioner(
            A, int(kw.pop("block_size", 8)), dtype=B_dev.dtype
        )
        method = "cg"
    elif method == "mgcg":
        from conjugategradient_tpu.precond import build_hierarchy

        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        h = build_hierarchy(A, grid, dtype=np.dtype(B_dev.dtype))
        M = as_multi_preconditioner(h)
    elif method == "amg_cg":
        from conjugategradient_tpu.precond import amg_preconditioner, build_amg_hierarchy

        setup_kw = {
            k: kw.pop(k)
            for k in ("theta", "near_null", "max_coarse", "max_levels")
            if k in kw
        }
        h = build_amg_hierarchy(A, dtype=np.dtype(B_dev.dtype), **setup_kw)
        M = amg_preconditioner(h)  # (n, k)-aware (vmapped cycle)
        method = "cg"
    elif method in (
        "bicgstab", "jacobi_bicgstab", "bjacobi_bicgstab", "mg_bicgstab",
        "amg_bicgstab",
    ):
        # multi-RHS NONSYMMETRIC: per-column BiCGStab recurrences sharing
        # one SpMM pass per half-step (solvers.multi.bicgstab_solve_multi);
        # prefixes build the same right preconditioners as the single-RHS
        # routes, applied blockwise
        from conjugategradient_tpu.solvers.multi import bicgstab_solve_multi

        if method == "jacobi_bicgstab":
            inv = jnp.asarray(1.0 / _diagonal(A), dtype=B_dev.dtype)
            M = lambda R: inv[:, None] * R
        elif method == "bjacobi_bicgstab":
            from conjugategradient_tpu.precond import block_jacobi_preconditioner

            M = block_jacobi_preconditioner(
                A, int(kw.pop("block_size", 8)), dtype=B_dev.dtype
            )
        elif method == "mg_bicgstab":
            from conjugategradient_tpu.precond import build_hierarchy

            if grid is None:
                raise ValueError("mg_bicgstab requires grid=")
            if not isinstance(A, DiaMatrix):
                raise TypeError("mg_bicgstab requires a DiaMatrix")
            h = build_hierarchy(
                A, grid, smoother=kw.pop("smoother", "jacobi"),
                dtype=np.dtype(B_dev.dtype),
                coarse_operator=kw.pop("coarse_operator", None),
            )
            M = as_multi_preconditioner(h)
        elif method == "amg_bicgstab":
            from conjugategradient_tpu.precond import (
                amg_preconditioner,
                build_amg_hierarchy,
            )

            setup_kw = {
                k: kw.pop(k)
                for k in ("theta", "near_null", "max_coarse", "max_levels")
                if k in kw
            }
            setup_kw.setdefault("smoother", "jacobi")
            h = build_amg_hierarchy(A, dtype=np.dtype(B_dev.dtype), **setup_kw)
            M = amg_preconditioner(h)
        return bicgstab_solve_multi(A_dev, B_dev, X0_dev, policy, M=M, **kw)
    elif method != "cg":
        raise ValueError(f"method {method!r} does not support (n, k) right-hand sides")
    return cg_solve_multi(A_dev, B_dev, X0_dev, policy, M=M, **kw)


def _auto_method(A, grid) -> str:
    """Pick a solver from the matrix's structure (host-side probe).

    Symmetric + positive-definite-looking -> CG (MGCG when a grid is
    given); symmetric indefinite -> MINRES; nonsymmetric -> BiCGStab
    (mg_bicgstab with a grid).  Definiteness is probed by positive
    diagonal + a 120-step full-reorth Lanczos lower bound (exact
    Gershgorin positivity would be sufficient but rejects most
    interesting SPD systems; 30 steps measurably MISSES a -1.5*lambda_1
    Helmholtz shift on a 63x63 grid, 120 resolves it exactly).  A deeply
    clustered interior negative eigenvalue can still evade the probe —
    when in doubt pass method="minres" explicitly (it is also correct,
    just marginally slower, on SPD systems).
    """
    diag = _diagonal(A)
    tol_sym = 1e-12 * float(np.max(np.abs(diag)))
    if not formats.is_symmetric(A, tol=tol_sym):
        # no grid -> IDR(s), not plain BiCGStab: fp32 BiCGStab measurably
        # stagnates/diverges at scale on convection-dominated systems
        # (255^2 eps=0.5 tol 2e-6: BiCGStab blows up to 5e+16 at a
        # 20000-iteration cap while IDR(4) converges in 7010 its —
        # test_api_auto).  With a
        # grid the V-cycle-preconditioned form is the robust choice.
        return "mg_bicgstab" if grid is not None else "idr"
    if not _spd_probe(A, diag):
        return "minres"
    return "mgcg" if grid is not None else "cg"


def _spd_probe(A, diag=None) -> bool:
    """Positive diagonal + a 120-step full-reorth Lanczos lower bound (see
    ``_auto_method``'s docstring for the calibration)."""
    if diag is None:
        diag = _diagonal(A)
    spd = bool(np.all(diag > 0))
    if spd:
        from conjugategradient_tpu.core import oracle
        from conjugategradient_tpu.solvers.eigen import lanczos_bounds

        lo, _hi = lanczos_bounds(
            lambda v: oracle.spmv(A, v), A.shape[0], k=min(A.shape[0], 120)
        )
        spd = lo > -1e-10 * abs(_hi)
    return spd


def eigs(
    A,
    k: int = 6,
    which: str = "LM",
    sigma: Optional[float] = None,
    method: str = "auto",
    mesh=None,
    tol: Optional[float] = None,
    grid=None,
    spd: Optional[bool] = None,
    **kw,
):
    """k eigenpairs of a sparse operator — the eigensolver facade.

    The eigen counterpart of ``solve()``: dispatch by structure, one entry
    point.  Returns ``solvers.arnoldi.EigsResult`` (complex values/vectors,
    per-pair residuals, convergence flags) from every route.

    ``method``:
      - ``"auto"`` (default): symmetric operators with extremal selections
        (LM/SM/LR/SR, no shift) route to the BLOCK solver LOBPCG —
        multiplicity-safe (a single-vector Krylov space holds ONE vector
        per eigenspace; the square Laplacians here have multiplicity-2
        spectra throughout) and preconditionable (pass ``grid=`` to build
        an MGCG hierarchy, or ``M=`` an (n, k)-block preconditioner).
        Everything else — nonsymmetric operators, complex spectra, LI
        selection, shift-invert — routes to Krylov-Schur Arnoldi.
      - ``"arnoldi"`` | ``"lobpcg"``: force a route.

    ``spd``: caller hint for the auto route — ``True`` routes symmetric-
    positive-definite operators straight to LOBPCG without the host-side
    structure probe (which costs minutes above a few million rows and is
    never run past 4M rows), ``False`` forces Arnoldi.

    ``sigma``: shift-invert (Arnoldi route; nearest-to-sigma first; inner
    IDR(4) solves — see ``arnoldi_eigs``).  ``mesh``: distributed twins
    (``gspmd_lobpcg`` / ``gspmd_arnoldi_eigs``, row-sharded over the mesh).

    The reference's one eigensolver is the symmetric-only Jacobi-rotation
    routine inside its ELL matrix (``Mgcg/HandmadeCL/MgcgCL/
    SparseMatrix.cs:234-372``, used for spectrum diagnostics); this facade
    covers that capability (symmetric path) and the nonsymmetric family the
    reference cannot express.
    """
    from conjugategradient_tpu.solvers.arnoldi import (
        EigsResult,
        arnoldi_eigs,
        gspmd_arnoldi_eigs,
    )

    if method not in ("auto", "arnoldi", "lobpcg"):
        raise ValueError(f"unknown eigs method {method!r}; want auto|arnoldi|lobpcg")
    if which not in ("LM", "SM", "LR", "SR", "LI"):
        raise ValueError(f"unknown which={which!r}; want LM|SM|LR|SR|LI")
    if method == "auto":
        # the LOBPCG route needs SPD, not just symmetry: it selects by
        # ALGEBRAIC extremes, so for symmetric INDEFINITE operators LM/SM
        # (magnitude selections) would silently return the wrong end of the
        # spectrum (e.g. the most-negative Helmholtz mode for which="SM");
        # definiteness makes LM==LR and SM==SR and the mapping exact.
        # ``spd=True`` asserts that property and skips the probe entirely;
        # above the size cap the host-side probe (a symmetry comparison plus
        # a 120-step full-reorth fp64 Lanczos — minutes of silent setup at
        # 100M rows) is never run: pass spd= or method= explicitly there.
        _PROBE_CAP = 4_000_000
        eligible = sigma is None and which != "LI"
        if spd is not None:
            sym = eligible and bool(spd)
        elif (
            eligible
            and hasattr(A, "shape")
            and not callable(A)
            and A.shape[0] <= _PROBE_CAP
        ):
            sym = formats.is_symmetric(A, tol=1e-12 * _diag_scale(A)) and _spd_probe(A)
        else:
            if eligible and hasattr(A, "shape") and not callable(A):
                import warnings

                warnings.warn(
                    f"eigs(method='auto'): n={A.shape[0]} exceeds the "
                    f"{_PROBE_CAP}-row structure-probe cap; routing to "
                    "Arnoldi.  Pass spd=True (or method='lobpcg') for the "
                    "symmetric block solver.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            sym = False
        method = "lobpcg" if sym else "arnoldi"

    if method == "lobpcg":
        import jax.numpy as jnp

        from conjugategradient_tpu.solvers.lobpcg import gspmd_lobpcg, lobpcg

        if tol is None:
            # dtype-aware default: LOBPCG's default dtype is fp32, whose
            # attainable residual floor is ~1e-6 — an fp64-grade default
            # would burn the whole iteration budget and return
            # converged=False with accurate values (the same failure mode
            # as the shift-invert inner_tol fix)
            dt = kw.get("dtype")
            fp64 = dt is not None and np.dtype(dt) == np.float64
            # fp32 floor measured at ~2e-6 relative on the Poisson LM end
            # (residual scales with lam_max/gap); 1e-5 keeps a margin
            tol = 1e-8 if fp64 else 1e-5
        largest = which in ("LM", "LR")
        M = kw.pop("M", None)
        if M is None and grid is not None and not largest:
            # smallest eigenpairs of an SPD grid operator: precondition with
            # the MGCG hierarchy (the measured 200 -> 4 iteration cut)
            from conjugategradient_tpu.precond import build_hierarchy
            from conjugategradient_tpu.solvers.multi import as_multi_preconditioner

            h = build_hierarchy(A, tuple(grid), dtype=kw.get("dtype", jnp.float32))
            M = as_multi_preconditioner(h)
        if mesh is not None:
            res = gspmd_lobpcg(A, k, mesh, M=M, largest=largest, tol=tol, **kw)
        else:
            res = lobpcg(A, k, M=M, largest=largest, tol=tol, **kw)
        vals = np.asarray(res.eigenvalues, np.float64)
        # LOBPCG returns ascending; re-order most-wanted-first like Arnoldi
        order = np.argsort(-vals if largest else vals, kind="stable")
        vecs = np.asarray(res.eigenvectors, np.float64)[:, order]
        lam = vals[order]
        return EigsResult(
            values=lam.astype(np.complex128),
            vectors=vecs.astype(np.complex128),
            residuals=np.asarray(res.residuals, np.float64)[order] * (np.abs(lam) + 1.0),
            matvecs=int(res.iterations) * 3 * k,
            restarts=int(res.iterations),
            converged=bool(res.converged),
        )

    if tol is None:
        tol = 1e-8  # arnoldi's tol is RELATIVE to |lambda| (its own default)
    if mesh is not None:
        return gspmd_arnoldi_eigs(A, k, mesh=mesh, which=which, sigma=sigma, tol=tol, **kw)
    return arnoldi_eigs(A, k, which=which, sigma=sigma, tol=tol, **kw)


def _diag_scale(A) -> float:
    try:
        return float(np.max(np.abs(_diagonal(A))))
    except Exception:
        return 1.0


def _to_csr(A) -> formats.CsrMatrix:
    return formats._any_to_csr(A)


def _diagonal(A) -> np.ndarray:
    return formats.matrix_diagonal(A)
