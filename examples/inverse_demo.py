"""Inverse problem demo: recover operator coefficients by differentiating
THROUGH the solver.

The capability a functional-transform framework adds over the reference's
C#/CUDA design: ``x(theta) = A(theta)^-1 b`` is a differentiable function
of the matrix entries (``solvers.diff.cg_solve_implicit`` — implicit
adjoint, one extra CG solve per gradient), so parameter estimation is just
``jax.grad`` + an optimizer.

Setup: a banded SPD operator whose diagonal carries an unknown
per-row "stiffness" field theta_true; we observe the solution x_obs
(optionally noisy) and recover theta from scratch with Adam.

Run:  python examples/inverse_demo.py --cpu
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--band", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax

    from conjugategradient_tpu.core import generators
    from conjugategradient_tpu.solvers.diff import cg_solve_implicit
    from conjugategradient_tpu.solvers.policy import ConvergencePolicy
    from conjugategradient_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()

    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    sys_ = generators.banded_sin_system(args.n, args.band, dtype=dtype)
    offs, shape = sys_.A.offsets, sys_.A.shape
    diag_k = offs.index(0)
    base_data = jnp.asarray(np.asarray(sys_.A.data))
    b = jnp.asarray(sys_.b)
    pol = ConvergencePolicy(tol=1e-12, norm="rel_l2", max_iteration=4000)

    rng = np.random.default_rng(0)
    theta_true = jnp.asarray(0.5 + 0.4 * rng.random(args.n))

    def forward(theta):
        data = base_data.at[diag_k].add(theta)
        return cg_solve_implicit(data, b, offs, shape, pol)

    x_obs = forward(theta_true)
    if args.noise > 0:
        x_obs = x_obs + args.noise * jnp.asarray(rng.standard_normal(args.n))

    def loss(theta):
        return jnp.mean((forward(theta) - x_obs) ** 2)

    opt = optax.adam(5e-2)
    theta = jnp.zeros(args.n)
    state = opt.init(theta)
    valgrad = jax.jit(jax.value_and_grad(loss))

    t0 = time.perf_counter()
    l0 = float(loss(theta))
    for step in range(args.steps):
        l, g = valgrad(theta)
        updates, state = opt.update(g, state)
        theta = optax.apply_updates(theta, updates)
        if step % 100 == 0:
            print(f"  step {step:4d}  loss {float(l):.3e}")
    wall = time.perf_counter() - t0
    l1 = float(loss(theta))
    err = float(jnp.linalg.norm(theta - theta_true) / jnp.linalg.norm(theta_true))
    print(
        f"loss {l0:.3e} -> {l1:.3e} in {args.steps} Adam steps ({wall:.1f} s); "
        f"relative coefficient error {err:.2e}"
    )
    # each gradient = 2 CG solves (forward + adjoint), O(n) memory.
    # With observation noise the achievable loss floor is ~noise^2 (the
    # MSE of fitting noise), not a fraction of l0
    loss_goal = 1e-6 * max(l0, 1e-30) if args.noise == 0 else 10.0 * args.noise**2
    ok = l1 < loss_goal and (err < 0.05 or args.noise > 0)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
