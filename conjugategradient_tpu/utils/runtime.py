"""Process set-up shared by the entry points (``chip_smoke.py``, ``bench.py``,
the examples): where JAX keeps its persistent compile cache, the check that
a measurement run really has a GPU, and the card's name and power limit.

Call ``setup_compile_cache`` once, before the first compilation.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it at import and this helper
sets nothing; otherwise the cache goes to one fixed directory inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``).  The path is part
of the cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

#: The checkout-local default cache directory.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


class NoGPUError(RuntimeError):
    """Raised by ``require_gpu`` when JAX's default backend is not a GPU."""


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory and return
    the directory in use.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and
    is left to JAX; otherwise ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise ``NoGPUError``
    otherwise.  A measurement never falls back to the CPU: a CPU number
    under a device metric's name is wrong, not approximate."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default backend is {platform!r} "
            f"({len(devices)} device(s))"
        )
    return devices


def card_info() -> str:
    """The cards' name and power limit, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them.  Runs as a child process that stays off JAX; raises if the query
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
