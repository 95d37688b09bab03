"""Pure-jnp overlap-add: the batched/offline OLA formulation.

Reference: dsp/ola/OLAAccumulator.{h,cc} — but instead of a serial per-frame
`ring.split + axpy` loop, the batched formulation (SURVEY.md §2.9 / §7 "hard
parts") reshapes each frame into R = ceil(N/H) hop-blocks and performs R
shifted block-adds:

    out_block[b] = sum_{r=0}^{R-1} hops[b - r, r]      (hops = frames
                                                        reshaped [F, R, H])

This is fully vectorized (R dynamic-update-slice adds over [F, H] planes, no
scatter, no races) and gives a deterministic left-to-right frame summation
order: the loop runs r = R-1 .. 0, so for any output position, earlier frames
are accumulated first — the canonical order the sharded halo exchange must
match for bit-consistency (SURVEY.md §7).

Frames whose length is not a hop multiple are zero-padded to R*H; zero
contributions are exact no-ops, so any (N, H <= N) pair is supported.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp


def overlap_count(frame_size: int, hop: int) -> int:
    return -(-frame_size // hop)


@partial(jax.jit, static_argnums=(1, 2))
def _overlap_add_impl(
    frames: jnp.ndarray, hop: int, out_len: int, init_head=None
) -> jnp.ndarray:
    f = frames.shape[-2]
    n = frames.shape[-1]
    r_count = overlap_count(n, hop)
    n_pad = r_count * hop
    if n_pad != n:
        pad = [(0, 0)] * (frames.ndim - 1) + [(0, n_pad - n)]
        frames = jnp.pad(frames, pad)
    hops = frames.reshape(*frames.shape[:-1], r_count, hop)
    blocks = f + r_count - 1
    out = jnp.zeros((*frames.shape[:-2], blocks, hop), dtype=frames.dtype)
    if init_head is not None:
        # Pre-seed the head with contributions from frames EARLIER than any
        # local frame (the left neighbor's OLA tail in the sharded pipeline).
        # Seeding before the loop keeps the per-position summation order
        # init -> ascending local frames == global left-to-right frame order,
        # which is what makes N-device output bit-identical to 1-device.
        h = init_head.shape[-1]
        out = out.reshape(*out.shape[:-2], blocks * hop).at[..., :h].add(
            init_head
        ).reshape(*out.shape[:-2], blocks, hop)
    # r descending => ascending frame index per output position (canonical
    # left-to-right summation order; see module docstring).
    for r in range(r_count - 1, -1, -1):
        out = out.at[..., r : r + f, :].add(hops[..., :, r, :])
    flat = out.reshape(*out.shape[:-2], blocks * hop)
    return flat[..., :out_len]


def overlap_add(
    frames: jnp.ndarray,
    hop: int,
    out_len: Optional[int] = None,
    init_head: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Overlap-add `frames[..., F, N]` at spacing `hop` -> `[..., out_len]`.

    Default out_len = (F-1)*hop + N (full span). Windowing/gain is the
    caller's job (compose with `frame_windowed` or multiply first) — this op
    is the pure accumulation, the analog of looping `add_frame_SoA` with
    `apply_window_inside=false` (OLAAccumulator.cc:81-111).

    `init_head[..., h]` (h <= out_len) pre-seeds the first h output samples
    BEFORE any frame is accumulated — used by the sharded pipeline to add the
    left neighbor's OLA tail in canonical (earliest-first) order.
    """
    frames = jnp.asarray(frames)
    if frames.ndim < 2:
        raise ValueError("frames must be at least 2-D [F, N]")
    f, n = frames.shape[-2], frames.shape[-1]
    if hop <= 0:
        raise ValueError(f"hop must be > 0, got {hop}")
    full = (f - 1) * hop + n
    if out_len is None:
        out_len = full
    if out_len <= 0:
        raise ValueError(f"out_len must be > 0, got {out_len}")
    if out_len > full:
        # Pad result with zeros beyond the covered span.
        y = _overlap_add_impl(frames, hop, full, init_head)
        widths = [(0, 0)] * (y.ndim - 1) + [(0, out_len - full)]
        return jnp.pad(y, widths)
    return _overlap_add_impl(frames, hop, out_len, init_head)


@partial(jax.jit, static_argnames=("eps",))
def normalize(
    acc: jnp.ndarray, norm: jnp.ndarray, eps: float = 1e-8
) -> jnp.ndarray:
    """`acc / max(norm, eps)` — the divide half of the reference's
    normalize_and_clear kernel (dsp/ola/kernels.cc:30-36); clearing has no
    meaning for the functional offline path."""
    norm = jnp.asarray(norm, dtype=acc.dtype)
    return acc / jnp.maximum(norm, jnp.asarray(eps, dtype=acc.dtype))


def overlap_add_normalized(
    frames: jnp.ndarray,
    hop: int,
    norm: jnp.ndarray,
    out_len: Optional[int] = None,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """OLA then divide by the COLA norm (crlot_tpu.ola.norm builders)."""
    y = overlap_add(frames, hop, out_len)
    return normalize(y, norm[: y.shape[-1]], eps)
