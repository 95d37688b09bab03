"""Multi-process setup: (processes x local devices) meshes.

SURVEY.md §5 'Distributed communication backend'. Each process runs the
same program under `jax.distributed`; `global_mesh()` lays the TIME axis so
consecutive time blocks sit on devices of the same process and only one
block edge per process crosses the process boundary, so the cross-process
traffic per pipeline step is a single (frame - hop)-sample boundary
exchange in each direction.

This module is exercised single-process in CI (process_count == 1 collapses
to the plain mesh); with several processes call `initialize()` first in
every one, with an explicit coordinator address, process count and id.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import CHANNEL_AXIS, TIME_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized or
    single-process with no coordinator configured).

    Must run before ANY backend-initializing jax call (jax.devices(),
    device_put, any computation) — so the check here uses
    jax.distributed.is_initialized(), NOT jax.process_count(), which would
    itself initialize the backend and make the real initialize() throw."""
    if jax.distributed.is_initialized():
        return  # already initialized
    if coordinator_address is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(channel: int = 1) -> Mesh:
    """(channel, time) mesh over ALL processes' devices, time-major within
    each process so halo ppermutes stay inside a process except at process
    boundaries.

    jax.devices() orders devices process-major already; reshaping
    [processes, devices_per_process] -> channel x time keeps each process's
    devices contiguous along the time axis.
    """
    devs = jax.devices()
    n = len(devs)
    if n % channel != 0:
        raise ValueError(f"{n} devices not divisible by channel={channel}")
    grid = np.asarray(devs).reshape(channel, n // channel)
    return Mesh(grid, (CHANNEL_AXIS, TIME_AXIS))


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
