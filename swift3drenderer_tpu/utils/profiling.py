"""Tracing / timing utilities.

The reference's only instrumentation is the 1 Hz frame-budget printout
(reference main.swift:143-153, mirrored in utils/telemetry.py). Here:
``jax.profiler`` trace capture around render calls, the device a number was
measured on, and wall-clock timing of device work that ends in
``block_until_ready`` (JAX returns before the device finishes).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_summary() -> dict:
    """The device numbers are taken on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_power_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (a card
    set below its maximum power runs slower under load), or "not available"
    off an NVIDIA card. Runs a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip() or "not available"


def median_ms(fn: Callable[[], object], *, reps: int = 10) -> float:
    """Median wall-clock milliseconds of ``reps`` calls of ``fn()``, each
    waited for with ``block_until_ready``. Not counted: the first call
    (compilation), then further calls until 0.3 s have passed — an idle GPU
    lowers its clocks, and a few milliseconds of work do not bring them back
    up."""
    import jax

    t_end = time.perf_counter() + 0.3
    jax.block_until_ready(fn())
    while time.perf_counter() < t_end:
        jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3
