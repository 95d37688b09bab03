"""Boundary padding with reflect101/edge/constant semantics.

Reference: dsp/frame/Indexing.h:18-33 (`reflect101`) and :44-70
(`getPaddingValueSafe`). Unlike `jnp.pad(mode='reflect')`, the index-based
formulation here supports pad amounts >= signal length (the reference's
modular fold handles arbitrary indices), and it lowers to a single gather,
which XLA fuses with downstream framing.
"""

from __future__ import annotations

import jax.numpy as jnp

from .types import PadMode


def reflect101_index(idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """Map (possibly out-of-range) indices into [0, n) by non-repeating
    reflection: for n=4, ...3,2,[0,1,2,3],2,1,0,1,...

    Matches the reference's `reflect101` (dsp/frame/Indexing.h:18-33): the
    reflection period is 2*(n-1) and boundary samples are not repeated.
    Degenerate n==1 maps everything to 0.
    """
    if n <= 1:
        return jnp.zeros_like(idx)
    period = 2 * (n - 1)
    m = jnp.abs(idx) % period
    return jnp.where(m >= n, period - m, m)


def edge_index(idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """Clamp indices to [0, n-1] (EDGE / replicate padding)."""
    return jnp.clip(idx, 0, max(n - 1, 0))


def pad_signal(
    x: jnp.ndarray,
    pad_left: int,
    pad_right: int,
    mode: PadMode = PadMode.CONSTANT,
    value: float = 0.0,
) -> jnp.ndarray:
    """Pad the last axis of `x` by (pad_left, pad_right) samples.

    Semantics match the reference's `getPaddingValueSafe`
    (dsp/frame/Indexing.h:44-70): CONSTANT fills `value`, REFLECT is
    reflect101, EDGE replicates boundary samples. Works for any pad amount,
    including pads longer than the signal.
    """
    if pad_left < 0 or pad_right < 0:
        raise ValueError("pad amounts must be >= 0")
    if pad_left == 0 and pad_right == 0:
        return x
    n = x.shape[-1]
    if mode == PadMode.CONSTANT:
        widths = [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)]
        return jnp.pad(x, widths, mode="constant", constant_values=value)
    if n == 0:
        raise ValueError(f"cannot {mode.value}-pad an empty signal")
    # Gathers over the whole signal are slow; build only the pad
    # EDGES and concat them around the untouched interior. The common
    # single-reflection case (pad < n) is a pure flip/slice; larger pads and
    # EDGE's degenerate cases fall back to a small gather over the pad only.
    def left_piece(p: int) -> jnp.ndarray:
        if mode == PadMode.EDGE:
            return jnp.repeat(x[..., :1], p, axis=-1)
        if p <= n - 1:  # reflect101 of -p..-1 is x[1..p] reversed
            return jnp.flip(x[..., 1 : p + 1], axis=-1)
        idx = reflect101_index(jnp.arange(-p, 0), n)
        return jnp.take(x, idx, axis=-1)

    def right_piece(p: int) -> jnp.ndarray:
        if mode == PadMode.EDGE:
            return jnp.repeat(x[..., -1:], p, axis=-1)
        if p <= n - 1:  # reflect101 of n..n+p-1 is x[n-1-p..n-2] reversed
            return jnp.flip(x[..., n - 1 - p : n - 1], axis=-1)
        idx = reflect101_index(jnp.arange(n, n + p), n)
        return jnp.take(x, idx, axis=-1)

    pieces = []
    if pad_left:
        pieces.append(left_piece(pad_left))
    pieces.append(x)
    if pad_right:
        pieces.append(right_piece(pad_right))
    return jnp.concatenate(pieces, axis=-1)
