"""Overlap-add + COLA-normalise in one pass over the frames.

`ola/reference.py` accumulates with R = ceil(N/H) dynamic-update-slice adds,
each of which reads and writes the whole output buffer. `ola_normalized`
writes the same sum as R shifted, zero-padded hop planes added in the same
order (r descending == ascending frame index) and divides by the norm in the
same expression, so XLA emits one fused loop that reads each frame once:

    out[b] = (sum_{r=R-1..0} hops[b - r, r]) / max(norm[b], eps)

Adding the zero padding is exact (a running sum that starts at +0.0 never
becomes -0.0), so the result is bit-identical to
`normalize(overlap_add(...))`: the canonical left-to-right frame order that
sharded and streamed outputs rely on is kept.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .reference import overlap_count


@partial(jax.jit, static_argnames=("hop", "out_len", "eps"))
def ola_normalized(
    frames: jnp.ndarray,  # [..., F, N] f32 (windowed output frames)
    norm: jnp.ndarray,  # [>= out_len] f32 COLA norm
    hop: int,
    out_len: int,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """`normalize(overlap_add(frames, hop, out_len), norm, eps)` as one
    fusion; see the module docstring."""
    lead = frames.shape[:-2]
    f, n = frames.shape[-2:]
    r_count = overlap_count(n, hop)
    n_pad = r_count * hop
    if n_pad != n:
        frames = jnp.pad(frames, ((0, 0),) * (frames.ndim - 1) + ((0, n_pad - n),))
    hops = frames.reshape(lead + (f, r_count, hop))
    acc = jnp.zeros(lead + (f + r_count - 1, hop), frames.dtype)
    for r in range(r_count - 1, -1, -1):
        acc = acc + jnp.pad(
            hops[..., :, r, :],
            ((0, 0),) * len(lead) + ((r, r_count - 1 - r), (0, 0)),
        )
    flat = acc.reshape(lead + ((f + r_count - 1) * hop,))
    if out_len > flat.shape[-1]:
        flat = jnp.pad(flat, ((0, 0),) * len(lead) + ((0, out_len - flat.shape[-1]),))
    norm = jnp.asarray(norm, frames.dtype)[:out_len]
    return flat[..., :out_len] / jnp.maximum(norm, jnp.asarray(eps, frames.dtype))

