"""Krylov-Schur (thick-restart Arnoldi) eigensolver for NONSYMMETRIC operators.

Completes the eigensolver family by symmetry class, the same way
``solvers.minres``/``bicgstab``/``gmres`` completed the linear-solver family:
the reference ships a symmetric Jacobi-rotation eigensolver inside its ELL
matrix (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:234-372``) and this repo adds
Lanczos bounds and LOBPCG — all symmetric-only.  The nonsymmetric solver
family (bicgstab / gmres / idr on convection-diffusion operators) creates the
demand this module serves: dominant/rightmost eigenvalues and spectral
diagnostics of operators with complex spectra, where Lanczos three-term
recurrences are simply wrong.

Method: Arnoldi with Krylov-Schur thick restarting (Stewart, SIAM J. Matrix
Anal. Appl. 23(3), 2001) — the restarting scheme behind ARPACK-style ``eigs``
but expressed through the ordered Schur form, which makes the restart a plain
basis contraction instead of implicit QR bulge-chasing.

Split of labour:

- DEVICE: the ``(m+1, n)`` basis expansion.  Orthogonalisation is CGS2 as two
  masked matmuls per step at ``MATMUL_PRECISION`` — identical design (and
  identical failure class if left at reduced precision: TF32 or bf16-pass
  fp32 matmuls lose orthogonality) to ``gmres_loop`` and ``solvers.lobpcg``.
  One jitted program per restart cycle; only the tiny projected matrix
  leaves the device.
- HOST: the ``(m, m)`` projected eigen/Schur work per restart —
  ``numpy.linalg.eig`` + ``scipy.linalg.schur(sort=...)`` on a ~32x32 matrix,
  orders of magnitude below one n-sized matvec; host-driving the restarts is
  the right placement, exactly as ``precond.multigrid`` host-drives setup.

The restart contraction ``V_p = Q[:, :p]^T V_m`` IS an ``(p, m) @ (m, n)``
matmul and runs on device at ``MATMUL_PRECISION``; the coupling row ``b^T`` is
folded into row ``p`` of the projected matrix ``S`` so each later cycle keeps
the exact relation ``A V_m = S^T-contraction + beta v_m e_last^T`` and the
free residual estimate ``|beta * y[m-1]|`` per Ritz pair stays valid.

Shift-invert (``sigma=``) composes with the nonsymmetric solver stack: each
Arnoldi matvec becomes one inner Krylov solve of ``(A - sigma I) w = v``
(IDR(4) by default — the measured robust choice on the indefinite shifted
operator; BiCGStab/GMRES selectable) inside the same jitted expansion, and
the returned eigenvalues are mapped back ``lambda = sigma + 1/theta``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from conjugategradient_tpu.ops.blas import dot as _dot
from conjugategradient_tpu.ops.spmv import as_operator
from conjugategradient_tpu.solvers.cg import _safe_div

from conjugategradient_tpu.ops.precision import MATMUL_PRECISION

# Jitted expansions are cached at module scope, keyed by (apply_op, m, p,
# precise_dot) — repeated arnoldi_eigs calls reuse the compilation, and the
# matrix rides through jit AS AN ARGUMENT pytree (never a closure constant:
# closure constants are baked into the compiled program — the repo-wide
# rule, see ``solvers/cg.py`` run_chunk).
#
# Both caches are small LRUs (ordered dicts, oldest-entry eviction): shift-
# invert keys include the USER's M/operator callables, whose closed-over
# state (hierarchies, matrices) stays referenced while cached — a bounded
# LRU caps that retention without the wholesale clear() that would evict
# hot entries and force recompiles.  Callers doing repeated shift-invert
# solves should pass the SAME M object each time to stay on one entry.
from collections import OrderedDict

_EXPAND_CACHE: OrderedDict = OrderedDict()
_APPLY_CACHE: OrderedDict = OrderedDict()
_EXPAND_CAP = 64
_APPLY_CAP = 16


def _lru_get(cache: OrderedDict, key):
    fn = cache.get(key)
    if fn is not None:
        cache.move_to_end(key)
    return fn


def _lru_put(cache: OrderedDict, key, fn, cap: int):
    cache[key] = fn
    cache.move_to_end(key)
    while len(cache) > cap:
        cache.popitem(last=False)


def _apply_direct(A_args, v):
    """op_args = (A,): one matrix application; always 'converged'."""
    (A,) = A_args
    return as_operator(A)(v), jnp.bool_(True)


def _get_shift_apply(
    M,
    inner_tol: float,
    inner_max_iteration: int,
    op_callable=None,
    inner_method: str = "idr",
):
    """w = (A - sigma I)^{-1} v by an inner Krylov solve, carrying the
    inner solve's converged flag (an inexact inverse silently corrupts the
    Arnoldi relation — the flag is AND-reduced across the whole run and
    surfaced as ``EigsResult.inner_converged``).  Matrix containers arrive
    in op_args = (A, sigma); a raw-callable operator stays in closure
    (op_args = (sigma,)) and keys the cache by its own identity.

    ``inner_method`` defaults to IDR(4): sigma inside/near the spectrum
    makes the shifted operator indefinite, where plain BiCGStab breaks down
    (measured on the 16^2 eps=0.1 convection-diffusion operator at
    sigma=0.05: BiCGStab caps 10000 its at residual 6e4 on basis vector 1;
    GMRES(40) stagnates at 1e-5; IDR(4) converges every solve in ~190 its
    to 1e-10)."""
    if inner_method not in ("idr", "bicgstab", "gmres"):
        raise ValueError(f"unknown inner_method {inner_method!r}")
    key = (
        "shift", M, float(inner_tol), int(inner_max_iteration), op_callable,
        inner_method,
    )
    fn = _lru_get(_APPLY_CACHE, key)
    if fn is not None:
        return fn
    from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu.solvers.gmres import gmres_solve
    from conjugategradient_tpu.solvers.idr import idr_solve
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy

    pol = ConvergencePolicy(
        tol=float(inner_tol), norm="rel_l2", max_iteration=int(inner_max_iteration)
    )

    def apply(A_args, v):
        if op_callable is None:
            A, sig = A_args
            op0 = as_operator(A)
        else:
            (sig,) = A_args
            op0 = op_callable
        shifted = lambda u: op0(u) - sig * u
        if inner_method == "idr":
            res = idr_solve(shifted, v, policy=pol, M=M, s=4)
        elif inner_method == "gmres":
            res = gmres_solve(shifted, v, policy=pol, M=M, restart=40)
        else:
            res = bicgstab_solve(shifted, v, policy=pol, M=M)
        return res.x, res.converged

    _lru_put(_APPLY_CACHE, key, apply, _APPLY_CAP)
    return apply


def _get_callable_apply(op: Callable):
    """User-supplied raw operator: the callable itself is the cache key (its
    own closed-over state is the user's contract, not matrix data we staged)."""
    key = ("callable", op)
    fn = _lru_get(_APPLY_CACHE, key)
    if fn is None:
        fn = lambda A_args, v: (op(v), jnp.bool_(True))
        _lru_put(_APPLY_CACHE, key, fn, _APPLY_CAP)
    return fn


def _get_expand(apply_op, m: int, p: int, precise_dot: bool):
    key = (apply_op, m, p, precise_dot)
    fn = _lru_get(_EXPAND_CACHE, key)
    if fn is None:
        fn = _make_expand(apply_op, m, p, precise_dot)
        _lru_put(_EXPAND_CACHE, key, fn, _EXPAND_CAP)
    return fn


@dataclasses.dataclass(frozen=True)
class EigsResult:
    """k approximate eigenpairs of a (generally nonsymmetric) operator.

    ``values``/``vectors`` are complex numpy arrays (real inputs with real
    spectra come back with zero imaginary parts); ``vectors`` columns have
    unit 2-norm.  ``residuals[i]`` is ``||A x_i - lambda_i x_i||_2``: the
    free Arnoldi recurrence estimate for plain solves (exact in exact
    arithmetic), and under shift-invert a directly recomputed TRUE residual
    (k extra plain matvecs — the first-order back-transform of the
    transformed-space estimate is unreliable near the shift).  ``matvecs``
    counts operator applications (= inner SOLVES under shift-invert).

    SHORT RETURN: on lucky breakdown (an exact invariant subspace smaller
    than ``k``, e.g. a (scaled) identity block) the arrays may carry FEWER
    than ``k`` entries after the deflate-restart budget is exhausted — the
    pairs returned are then exact (zero residuals) but ``converged`` is
    False.  Callers indexing ``values[k-1]`` must check ``len(values)``.
    """

    values: np.ndarray  # (k,) complex128
    vectors: np.ndarray  # (n, k) complex128, unit columns
    residuals: np.ndarray  # (k,) float64
    matvecs: int
    restarts: int
    converged: bool
    inner_converged: bool = True  # shift-invert only: every inner BiCGStab
    # solve hit inner_tol (False = the Arnoldi relation used an inexact
    # inverse; eigenvalues may be off even when ``converged`` is True)


def _order(which: str, theta: np.ndarray) -> np.ndarray:
    """Indices of ``theta`` sorted most-wanted first."""
    if which == "LM":
        key = -np.abs(theta)
    elif which == "SM":
        key = np.abs(theta)
    elif which == "LR":
        key = -theta.real
    elif which == "SR":
        key = theta.real
    elif which == "LI":
        key = -np.abs(theta.imag)
    else:
        raise ValueError(f"unknown which={which!r}; want LM|SM|LR|SR|LI")
    return np.argsort(key, kind="stable")


def _schur_select(which: str, theta_keep: np.ndarray):
    """A pointwise Schur-sort predicate that marks (at least) the kept set.

    scipy's ordered Schur takes a per-eigenvalue boolean, so 'top p' is
    expressed as a threshold on the sort key; ties may select a few extra —
    the caller widens p to the returned ``sdim`` (never splits the wanted
    set, never splits a 2x2 real-Schur block).
    """
    eps = 1e-12
    if which == "LM":
        cut = np.abs(theta_keep).min()
        return lambda re, im: np.hypot(re, im) >= cut * (1 - eps) - eps
    if which == "SM":
        cut = np.abs(theta_keep).max()
        return lambda re, im: np.hypot(re, im) <= cut * (1 + eps) + eps
    if which == "LR":
        cut = theta_keep.real.min()
        return lambda re, im: re >= cut - eps - abs(cut) * eps
    if which == "SR":
        cut = theta_keep.real.max()
        return lambda re, im: re <= cut + eps + abs(cut) * eps
    if which == "LI":
        cut = np.abs(theta_keep.imag).min()
        return lambda re, im: abs(im) >= cut * (1 - eps) - eps
    raise ValueError(which)


def _make_expand(apply_op, m: int, p: int, precise_dot: bool):
    """Jitted Arnoldi expansion from basis row ``p`` to ``m`` (static p, m:
    exactly two compilations per solve — p=0 for the first cycle, p=restart
    thickness for all later ones).  The operator state (matrix pytree,
    shift) arrives as the ``A_args`` ARGUMENT; ``apply_op(A_args, v)``
    returns ``(w, ok)`` where ``ok`` carries inner-solve convergence under
    shift-invert (AND-reduced over the whole expansion)."""
    rows = jnp.arange(m + 1)

    def expand(A_args, V, S):
        dtype = V.dtype

        def step(j, carry):
            V, S, beta, ok = carry
            vj = jax.lax.dynamic_index_in_dim(V, j, keepdims=False)
            w, w_ok = apply_op(A_args, vj)
            mask = (rows <= j).astype(dtype)
            h1 = mask * jnp.matmul(V, w, precision=MATMUL_PRECISION)
            w = w - jnp.matmul(h1, V, precision=MATMUL_PRECISION)
            h2 = mask * jnp.matmul(V, w, precision=MATMUL_PRECISION)
            w = w - jnp.matmul(h2, V, precision=MATMUL_PRECISION)
            h = h1 + h2
            wn = jnp.sqrt(_dot(w, w, precise=precise_dot))
            # lucky-breakdown guard: after CGS2 the leftover w is pure
            # rounding noise whenever vj's image lies in the basis span —
            # wn is then ~eps * ||A vj||, NEVER exactly zero, and
            # normalising it would inject a garbage direction (measured:
            # the identity matrix produced beta=225 from 1e-17 leftovers).
            # Zero the direction instead; the host detects the zero
            # subdiagonal and deflates/truncates.
            hn = jnp.sqrt(jnp.sum(h * h))
            live = wn > hn * (100.0 * jnp.finfo(dtype).eps)
            wn = jnp.where(live, wn, jnp.zeros_like(wn))
            V = V.at[j + 1].set(
                jnp.where(live, _safe_div(1.0, wn) * w, jnp.zeros_like(w))
            )
            # column j of S holds h[:m] with the subdiagonal wn at row j+1;
            # for j == m-1 that entry falls OUTSIDE S — it is beta, the
            # residual coupling carried separately
            hcol = (h.at[j + 1].set(wn))[:m]
            S = S.at[:, j].set(hcol)
            return V, S, wn, jnp.logical_and(ok, w_ok)

        V, S, beta, ok = jax.lax.fori_loop(
            p, m, step, (V, S, jnp.asarray(0.0, V.dtype), jnp.bool_(True))
        )
        return V, S, beta, ok

    return jax.jit(expand)


def arnoldi_eigs(
    A,
    k: int = 6,
    m: Optional[int] = None,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 60,
    sigma: Optional[float] = None,
    inner_tol: Optional[float] = None,
    inner_max_iteration: int = 10000,
    inner_method: str = "idr",
    n: Optional[int] = None,
    dtype=None,
    seed: int = 0,
    precise_dot: bool = False,
    M: Optional[Callable] = None,
    basis_sharding=None,
) -> EigsResult:
    """k eigenpairs of a square (nonsymmetric) operator by Krylov-Schur.

    ``A``: any matrix container or a callable ``v -> A @ v`` (pass ``n=``
    for callables).  ``which``: LM (largest magnitude, default) | SM | LR
    (rightmost) | SR (leftmost) | LI.  ``m``: Arnoldi subspace size
    (default ``max(20, 2k + 8)``, clamped to n).  ``tol`` is RELATIVE:
    converged when ``residual_i <= tol * max(|lambda_i|, 1e-300)``.

    ``sigma``: shift-invert — eigenvalues nearest ``sigma`` converge first
    (each matvec = one inner Krylov solve of ``(A - sigma I) w = v`` to
    ``inner_tol``; ``M`` optionally preconditions it).  ``inner_method``
    defaults to ``"idr"``: the shifted operator is indefinite when sigma
    sits in the spectrum's hull, where BiCGStab measurably breaks down and
    restarted GMRES stagnates while IDR(4) converges (see
    ``_get_shift_apply``); ``"bicgstab"``/``"gmres"`` remain selectable.  With
    ``sigma`` the ``which`` selection applies to the TRANSFORMED spectrum
    ``1 / (lambda - sigma)``, so the default LM = nearest-to-sigma; returned
    values are mapped back to the original problem and residuals are
    RECOMPUTED directly as ``||A x - lambda x||_2`` (k plain matvecs).
    ``inner_tol`` defaults by dtype: 1e-10 in fp64, 1e-6 in fp32 — an
    fp32-unreachable inner tolerance makes every matvec burn
    ``inner_max_iteration`` iterations AND apply an inexact inverse; the
    run-wide inner convergence is surfaced as ``inner_converged`` (check it:
    shift-invert results with ``inner_converged=False`` are suspect).

    For symmetric operators prefer ``solvers.lobpcg`` (extremal, with a
    V-cycle preconditioner) or ``eigen.lanczos_bounds``; this is the general
    tool those cannot be: complex spectra, interior nonsym eigenvalues.
    Known single-vector-Krylov property: a degenerate eigenvalue is found
    ONCE (the Krylov space holds one vector per eigenspace) — for clustered
    or multiple symmetric eigenvalues use the BLOCK solver (lobpcg).

    May return FEWER than k pairs when the operator's reachable invariant
    subspace is smaller than k (lucky breakdown with the deflate-restart
    budget exhausted) — see the ``EigsResult`` short-return note.
    """
    if n is None:
        if hasattr(A, "n"):
            n = int(A.n)
        else:
            raise ValueError("pass n= when A is a callable operator")
    if k < 1:
        raise ValueError("k must be >= 1")
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    if m is None:
        m = max(20, 2 * k + 8)
    m = int(min(m, n))
    if m < k + 2:
        raise ValueError(f"subspace m={m} must be >= k+2={k + 2}")

    if dtype is None:
        dtype = getattr(A, "dtype", None) or jnp.zeros(0).dtype
    dtype = jnp.zeros(0, dtype).dtype
    np_dtype = np.zeros(0, dtype).dtype
    eps = float(np.finfo(np_dtype).eps)

    # The operator state rides through jit as the A_args ARGUMENT pytree
    # (never a closure constant — the repo-wide rule); raw callables
    # keep their own closure by the user's contract.
    is_callable_op = callable(A) and not hasattr(A, "n")
    if sigma is not None:
        if inner_tol is None:
            # fp32's attainable BiCGStab floor is ~1e-6 rel_l2 (measured on
            # the convection-diffusion family); 1e-10 would burn
            # inner_max_iteration its per matvec AND stay inexact
            inner_tol = 1e-10 if np_dtype == np.float64 else 1e-6
        apply_op = _get_shift_apply(
            M, inner_tol, inner_max_iteration,
            op_callable=A if is_callable_op else None,
            inner_method=inner_method,
        )
        sig = jnp.asarray(sigma, dtype)
        A_args = (sig,) if is_callable_op else (A, sig)
    elif is_callable_op:
        apply_op = _get_callable_apply(A)
        A_args = ()
    else:
        apply_op = _apply_direct
        A_args = (A,)

    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    V = jnp.zeros((m + 1, n), dtype).at[0].set(jnp.asarray(v0, dtype))
    if basis_sharding is not None:
        # distributed twin (gspmd_arnoldi_eigs): the (m+1, n) basis is
        # row-block sharded over the mesh; GSPMD propagates the placement
        # through the expansion (halo-exchange SpMV + one all-reduce per
        # CGS2 Gram matmul) while the m x m host Schur work replicates
        V = jax.device_put(V, basis_sharding)
    S = jnp.zeros((m, m), dtype)

    # restart thickness: keep the k wanted plus half the discarded space —
    # the standard robustness pad (pure k-keep restarts stall on clustered
    # spectra); widened per-cycle for Schur-sort ties / 2x2 blocks
    p_keep = min(k + max(1, (m - k) // 2), m - 2)

    matvecs = 0
    theta = Y = None
    beta_f = 0.0
    mm = m  # effective subspace dimension (shrinks on lucky breakdown)
    wanted = np.arange(k)
    converged = False
    inner_ok = True
    restarts = 0
    deflations = 0
    p_cur = 0

    for restarts in range(1, max_restarts + 1):
        p = 0 if restarts == 1 else p_cur
        V, S, beta, ok_c = _get_expand(apply_op, m, p, precise_dot)(A_args, V, S)
        matvecs += m - p
        S_np = np.asarray(jax.device_get(S), np.float64)
        beta_f = float(beta)
        inner_ok = inner_ok and bool(ok_c)
        mm = m

        # ---- lucky breakdown (invariant subspace): wn ~ 0 zeroes every
        # later basis row, and np.linalg.eig of the padded S would surface
        # spurious zero eigenvalues that rank FIRST under which="SM" with
        # resid=0.  beta is already read back — detect on the host, truncate
        # to the invariant block (its Ritz pairs are exact), and if that
        # block is still too small, deflate-restart with a fresh random
        # direction orthogonalised against it.
        brk = 10.0 * eps * max(1.0, float(np.abs(S_np).max()))
        if beta_f <= brk:
            sub = np.abs(np.diag(S_np, -1))  # subdiagonal wn history
            tiny = [j for j in range(p, m - 1) if sub[j] <= brk]
            mm = (tiny[0] + 1) if tiny else m
            if mm < k and deflations < 8:
                deflations += 1
                w = jnp.asarray(rng.standard_normal(n), dtype)
                for _ in range(2):  # CGS2 against the invariant block
                    w = w - jnp.matmul(
                        jnp.matmul(V[:mm], w, precision=MATMUL_PRECISION), V[:mm],
                        precision=MATMUL_PRECISION
                    )
                w = w / jnp.sqrt(_dot(w, w, precise=precise_dot))
                V = V.at[mm].set(w)
                p_cur = mm
                if restarts < max_restarts:
                    continue
            S_np = S_np[:mm, :mm]
            theta, Y = np.linalg.eig(S_np)
            order = _order(which, theta)
            wanted = order[: min(k, mm)]
            beta_f = 0.0  # exact invariant subspace: residuals are zero
            converged = mm >= k
            break

        theta, Y = np.linalg.eig(S_np)  # unit eigvec columns
        order = _order(which, theta)
        wanted = order[:k]
        resid = beta_f * np.abs(Y[m - 1, wanted])
        floor = np.maximum(np.abs(theta[wanted]), 1e-300)
        if np.all(resid <= tol * floor):
            converged = True
            break
        if restarts == max_restarts:
            break

        # --- Krylov-Schur contraction to the leading ordered-Schur block ---
        import scipy.linalg

        keep = order[:p_keep]
        T, Q, sdim = scipy.linalg.schur(
            S_np, output="real", sort=_schur_select(which, theta[keep])
        )
        p_cur = max(p_keep, int(sdim))
        p_cur = min(p_cur, m - 1)
        # never split a 2x2 (complex-pair) block
        if p_cur < m and abs(T[p_cur, p_cur - 1]) > 0:
            p_cur += 1
        if p_cur >= m:
            p_cur = m - 1
            if abs(T[p_cur, p_cur - 1]) > 0:
                p_cur -= 1
        Q1 = jnp.asarray(Q[:, :p_cur], dtype)  # (m, p)
        Vp = jnp.matmul(Q1.T, V[:m], precision=MATMUL_PRECISION)  # (p, n) device contraction
        V = (
            jnp.zeros_like(V)
            .at[:p_cur]
            .set(Vp)
            .at[p_cur]
            .set(V[m])  # the residual direction continues the basis
        )
        S_new = np.zeros((m, m))
        S_new[:p_cur, :p_cur] = T[:p_cur, :p_cur]
        S_new[p_cur, :p_cur] = beta_f * Q[m - 1, :p_cur]  # coupling row b^T
        S = jnp.asarray(S_new, dtype)

    # --- assemble eigenpairs: x_i = V_mm^T y_i, two real device matmuls ---
    Yw = Y[:, wanted]  # (mm, k') complex
    Yr = jnp.asarray(np.ascontiguousarray(Yw.real), dtype)
    Yi = jnp.asarray(np.ascontiguousarray(Yw.imag), dtype)
    Xr = np.asarray(jax.device_get(jnp.matmul(Yr.T, V[:mm], precision=MATMUL_PRECISION)))
    Xi = np.asarray(jax.device_get(jnp.matmul(Yi.T, V[:mm], precision=MATMUL_PRECISION)))
    X = (Xr + 1j * Xi).T.astype(np.complex128)  # (n, k')
    nrm = np.linalg.norm(X, axis=0)
    nrm[nrm == 0] = 1.0
    X /= nrm
    vals = theta[wanted].astype(np.complex128)
    resid = beta_f * np.abs(Y[mm - 1, wanted]) / nrm
    if sigma is not None:
        # back-transform lambda = sigma + 1/theta, then RECOMPUTE residuals
        # directly against the original operator: the first-order mapping
        # est/|theta| of the transformed-space estimate misleads callers
        # near the shift, and k plain matvecs are negligible next to the
        # inner solves that produced the basis
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = sigma + 1.0 / theta[wanted]
        op_plain = A if is_callable_op else as_operator(A)
        # ONE batched round trip for all real+imag columns instead of a
        # device_get pair per eigenpair — stack the 2k' columns into one
        # vmapped application and read the whole block back at once
        kw_n = len(wanted)
        cols = jnp.asarray(
            np.concatenate([X.real.T, X.imag.T], axis=0), dtype
        )  # (2k', n)
        # lax.map, not vmap: user-supplied callables built on primitives
        # without batching rules (pure_callback host matvecs) are legal
        # operators here, and a scan-based map applies them per column
        # while still costing ONE device round trip for the whole block
        AX = np.asarray(jax.device_get(jax.lax.map(op_plain, cols)), np.float64)
        Ax_c = AX[:kw_n].astype(np.complex128) + 1j * AX[kw_n:]
        resid = np.linalg.norm(
            Ax_c - vals[:, None] * X.T, axis=1
        ).astype(np.float64)
    return EigsResult(
        values=vals,
        vectors=X,
        residuals=np.asarray(resid, np.float64),
        matvecs=matvecs,
        restarts=restarts,
        converged=bool(converged),
        inner_converged=bool(inner_ok),
    )


def gspmd_arnoldi_eigs(
    A,
    k: int = 6,
    mesh=None,
    axis: str = "x",
    dtype=None,
    **kw,
) -> EigsResult:
    """Mesh-distributed Krylov-Schur Arnoldi via GSPMD sharding annotations
    (the ``gspmd_lobpcg`` pattern, ``solvers/lobpcg.py:233``).

    The per-cycle device work is one banded SpMV plus (m+1, n)-basis matmuls
    at ``Precision.HIGHEST`` — exactly what GSPMD partitions well: the DIA
    data and the basis are placed row-sharded over ``axis`` and XLA derives
    the collectives (halo exchange for the SpMV, one all-reduce per Gram
    product), while the m x m Schur/eig work stays replicated on the host.
    Same trajectory as the single-device solver up to reduction rounding
    (tested on the virtual mesh).  Supports ``DiaMatrix``; other formats:
    shard by hand and call ``arnoldi_eigs(basis_sharding=...)``.

    The reference's only eigensolver is symmetric-only Jacobi rotations
    (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:234-372``) — this is the
    distributed nonsymmetric capability it cannot express.
    """
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from conjugategradient_tpu.core.formats import DiaMatrix

    if mesh is None:
        raise ValueError("gspmd_arnoldi_eigs needs a mesh")
    if not isinstance(A, DiaMatrix):
        raise TypeError("gspmd_arnoldi_eigs requires a DiaMatrix")
    if dtype is None:
        dtype = np.asarray(A.data).dtype
    data = jax.device_put(
        jnp.asarray(np.asarray(A.data), dtype=dtype),
        NamedSharding(mesh, P(None, axis)),
    )
    A_sharded = DiaMatrix(data, A.offsets, A.shape)
    return arnoldi_eigs(
        A_sharded,
        k,
        dtype=dtype,
        basis_sharding=NamedSharding(mesh, P(None, axis)),
        **kw,
    )
