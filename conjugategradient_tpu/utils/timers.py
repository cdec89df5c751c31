"""Phase timing — the reference's measurement discipline, made device-correct.

The reference hand-times every solver: .NET ``Stopwatch`` ticks +
ticks-per-iteration (``Mgcg/cuBlas/Mgcg/MgcgMain.cs:110-126,165-167``),
input/exec/output ms splits (``Mgcg/ViennaCL/MgcgCL/MgcgCLMain.cs:116-134``),
``boost::timer`` seconds (``SimpleConjugateGradient.cu:223-239``).  On an
accelerator a wall-clock around an async dispatch measures nothing — every phase here ends
with ``jax.block_until_ready`` on the phase's outputs, and the report keeps the
reference's formats (per-phase ms, per-iteration microseconds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Phase:
    name: str
    seconds: float

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


class PhaseTimer:
    """Accumulates named, device-synchronised phases.

    >>> t = PhaseTimer()
    >>> with t.phase("input"):
    ...     dev = jax.device_put(host_array)          # doctest: +SKIP
    >>> with t.phase("solve", sync=result):           # doctest: +SKIP
    ...     result = solve(dev)
    >>> print(t.report(iterations=int(result.iterations)))  # doctest: +SKIP
    """

    def __init__(self) -> None:
        self.phases: List[Phase] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None):
        """Time a phase; if ``sync`` is given (array/pytree), block on it.

        ``sync`` may also be a zero-arg callable evaluated at phase end that
        returns the value to block on (for outputs created inside the block).
        """
        import jax

        t0 = time.perf_counter()
        holder: Dict[str, Any] = {}
        try:
            yield holder
        finally:
            target = holder.get("sync", sync)
            if callable(target) and not hasattr(target, "shape"):
                target = target()
            if target is not None:
                jax.block_until_ready(target)
            self.phases.append(Phase(name, time.perf_counter() - t0))

    def __getitem__(self, name: str) -> float:
        for p in reversed(self.phases):
            if p.name == name:
                return p.seconds
        raise KeyError(name)

    @property
    def total(self) -> float:
        return sum(p.seconds for p in self.phases)

    def report(self, iterations: Optional[int] = None) -> str:
        """The ViennaCL-driver style input/exec/output report, extended."""
        parts = [f"{p.name} {p.ms:9.2f} ms" for p in self.phases]
        line = " | ".join(parts) + f" | total {self.total*1e3:9.2f} ms"
        if iterations:
            solve_s = None
            for p in self.phases:
                if p.name in ("solve", "exec", "compute"):
                    solve_s = p.seconds
            per_it = (solve_s if solve_s is not None else self.total) / max(iterations, 1)
            line += f" | {iterations} it, {per_it*1e6:.1f} us/it"
        return line

    def as_dict(self) -> Dict[str, float]:
        return {p.name: p.seconds for p in self.phases}


def per_step_seconds(step, x0, *operands, ks=(8, 72), tries=3) -> float:
    """Device time of one ``x -> step(x, *operands)`` application.

    A ``lax.scan`` chains k dependent steps inside one program, and two
    chain lengths ``ks`` are differenced, so dispatch and read-back cancel;
    each length is the best of ``tries`` warm runs.  Arrays the step reads
    go in ``operands``: they stay arguments, never constants baked into the
    executable.  The scan returns the whole carry, so no step can be
    sliced away."""
    import jax

    best = {}
    for k in ks:
        def chain(x, *ops, k=k):
            return jax.lax.scan(lambda c, _: (step(c, *ops), None), x, None, length=k)[0]

        run = jax.jit(chain)
        jax.block_until_ready(run(x0, *operands))
        t = float("inf")
        for _ in range(tries):
            t0 = time.perf_counter()
            jax.block_until_ready(run(x0, *operands))
            t = min(t, time.perf_counter() - t0)
        best[k] = t
    return max((best[ks[1]] - best[ks[0]]) / (ks[1] - ks[0]), 1e-12)


def copy_rate_gb_s(n_words: int = 1 << 26, ks=(8, 72), tries=3) -> float:
    """The device's copy rate in this process: one read and one write of
    an fp32 array of ``n_words`` per step (``x * s``).  The default array
    (256 MB) is far larger than any GPU's L2, so this is the HBM rate every
    bandwidth share is divided by."""
    import jax.numpy as jnp

    x = jnp.ones((n_words,), jnp.float32)
    t = per_step_seconds(lambda c: c * jnp.float32(0.999999), x, ks=ks, tries=tries)
    return 2 * 4 * n_words / t / 1e9


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """jax.profiler trace scope (no-op when ``log_dir`` is None) — the
    device-side profiling the reference never had (SURVEY.md §5.1)."""
    import jax

    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
