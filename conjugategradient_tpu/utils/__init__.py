"""Aux subsystems: phase timing, structured residual logs, checkpoint/resume
(SURVEY.md §5 — the observability and durability layers the reference only
had as Console.WriteLine and not at all, respectively)."""

from conjugategradient_tpu.utils import checkpoint, reslog, runtime, spy, timers  # noqa: F401
from conjugategradient_tpu.utils.checkpoint import (  # noqa: F401
    CGState,
    load_pytree,
    load_state,
    save_pytree,
    save_state,
)
from conjugategradient_tpu.utils.reslog import ResidualRecord, records_from_history  # noqa: F401
from conjugategradient_tpu.utils.spy import spy as spy_plot  # noqa: F401
from conjugategradient_tpu.utils.timers import (  # noqa: F401
    PhaseTimer,
    copy_rate_gb_s,
    per_step_seconds,
    profiler_trace,
)
