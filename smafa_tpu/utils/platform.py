"""Platform selection helpers.

``apply_platform_env()`` makes an explicit ``SMAFA_TPU_PLATFORM`` or
``JAX_PLATFORMS`` setting win over any platform configured earlier in the
process (for example by a site hook): it writes the choice into jax's
``jax_platforms`` config, which must happen before any jax backend
initializes. The CLI calls it on startup; CPU subprocess tests rely on it.
"""

from __future__ import annotations

import os
from pathlib import Path


def apply_platform_env() -> None:
    plat = os.environ.get("SMAFA_TPU_PLATFORM") or os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        try:
            if jax.config.jax_platforms != plat:
                jax.config.update("jax_platforms", plat)
        except RuntimeError:
            # backends already initialized — too late to switch; leave as-is
            pass


_DISPATCH_MS: float | None = None


def dispatch_latency_ms() -> float:
    """Measured host<->device round-trip latency in milliseconds, cached
    per process. Drives the defaults for knobs whose best value flips
    with link latency (the one-wave best-hit fusion, cluster pipeline
    depth): a locally attached device answers in about a millisecond or
    less, a CPU backend in microseconds, and a device behind a slow
    link can take far longer.

    The probe is a tiny ``device_put`` + fetch pair (no jit compile, so
    it measures the link and not the compiler), run twice with the min
    taken. Callers run after the backend is live (runner construction),
    so probing is cheap. ``SMAFA_TPU_DISPATCH_MS`` overrides (tests pin
    it)."""
    global _DISPATCH_MS
    env = os.environ.get("SMAFA_TPU_DISPATCH_MS")
    if env:
        return float(env)
    if _DISPATCH_MS is None:
        import time

        import jax
        import numpy as np

        x = np.zeros(8, np.int32)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            np.asarray(jax.device_put(x))
            best = min(best, (time.perf_counter() - t0) * 1e3)
        _DISPATCH_MS = best
    return _DISPATCH_MS


# Fixed cache directory inside the checkout (git-ignored). The path is
# part of what makes a cached program reusable, so it never varies.
_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compilation_cache_dir() -> Path:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else one fixed git-ignored directory inside the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else _CACHE_DIR


def enable_compilation_cache() -> None:
    """Persist XLA compiles across CLI invocations.

    Short smafa jobs re-run the same handful of jit programs every
    invocation; the persistent cache turns each accelerator compile
    into a disk hit. Opt out with SMAFA_TPU_NO_COMPILE_CACHE=1.
    """
    if os.environ.get("SMAFA_TPU_NO_COMPILE_CACHE", "") not in ("", "0"):
        return
    # Callers are the device runners and bench — places where the backend
    # is initialized (or about to be) anyway, so querying it is free. The
    # CLI entry deliberately does NOT call this (the pure-host `count` op
    # must not initialize a device runtime, and multi-host programs must
    # not touch XLA before jax.distributed.initialize). CPU compiles are
    # fast and cached CPU AOT artifacts are machine-feature-sensitive
    # (cross-host loads warn about possible SIGILL), so only accelerator
    # compiles persist — unless an explicit JAX_COMPILATION_CACHE_DIR
    # opts in.
    import jax

    try:
        if (jax.default_backend() == "cpu"
                and "JAX_COMPILATION_CACHE_DIR" not in os.environ):
            return
    except RuntimeError:
        return
    try:
        cache_dir = compilation_cache_dir()
        cache_dir.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except (RuntimeError, OSError, AttributeError):
        pass
