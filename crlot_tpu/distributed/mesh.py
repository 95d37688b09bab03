"""Device mesh construction for channel x time-block sharding.

The reference is single-process (SURVEY.md §2.9: parallelism = SIMD only);
this module is the "distributed communication backend" this build adds as
a first-class component (SURVEY.md §5): a 2-D logical mesh

    ('channel', 'time')

where channels are embarrassingly parallel (the reference keeps per-channel
rings, OLAAccumulator.cc:26-28) and the time axis carries the frame-overlap
halo exchange. The cards of one host reach each other all to all over
NVLink at one rate, so the mesh follows the algorithm alone: no device
order is better than another.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def make_mesh(
    channel: int = 1,
    time: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (channel, time) mesh. `time=None` uses all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if time is None:
        if n % channel != 0:
            raise ValueError(f"{n} devices not divisible by channel={channel}")
        time = n // channel
    if channel * time > n:
        raise ValueError(
            f"mesh ({channel} x {time}) needs {channel * time} devices, have {n}"
        )
    import numpy as np

    grid = np.asarray(devices[: channel * time]).reshape(channel, time)
    return Mesh(grid, (CHANNEL_AXIS, TIME_AXIS))


def io_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for [channels, time] signal arrays."""
    return NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS, TIME_AXIS))


def auto_mesh(
    n_devices: Optional[int] = None, channels: Optional[int] = None
) -> Mesh:
    """Factor n devices into a near-square (channel, time) mesh, favoring a
    longer time axis (halos are cheap nearest-neighbor traffic; channel
    sharding needs the channel count to cooperate). Pass `channels` (the
    data's channel count) so the channel axis divides it — mono input gets
    a pure time mesh instead of an unusable channel split."""
    n = n_devices if n_devices is not None else len(jax.devices())
    channel = 1
    for c in range(int(n**0.5), 0, -1):
        if n % c == 0 and (channels is None or channels % c == 0):
            channel = c
            break
    return make_mesh(channel=channel, time=n // channel)
