"""What every measurement shares: the device it ran on, the compile cache,
and one timer.

A measurement names its device (platform, `device_kind`, count, and the
card's power limit, which caps its clocks under load) and refuses to run
anywhere but a GPU: a time taken on the CPU backend is not a device number.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it. `JAX_COMPILATION_CACHE_DIR`, when set, wins (JAX reads it
    itself); otherwise the cache is `.jax_cache/` inside the checkout, a
    path that never moves, so a later run in the same checkout finds it."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU; JAX's first device is {platform!r}"
        )


def device_record() -> Dict[str, object]:
    """platform, device_kind and count as JAX reports them, plus the card's
    name and power limit."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "name_power_limit": gpu_name_and_power_limit(),
    }


def time_call(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> dict:
    """Median and p90 wall time of `fn(*args)`, each call ending in
    `block_until_ready`, after `warmup` untimed calls (the first compiles)."""
    import jax

    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "median_s": float(np.median(times)),
        "p90_s": float(np.percentile(times, 90)),
        "iters": iters,
    }
