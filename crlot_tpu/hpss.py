"""Harmonic/percussive source separation (HPSS) by median-filter masking.

Fitzgerald 2010: on a magnitude spectrogram, harmonic content is smooth
along TIME (horizontal ridges) and percussive content is smooth along
FREQUENCY (vertical spikes). Median-filter the spectrogram along each axis,
build soft masks from the two filtered copies, apply to the complex STFT,
and invert.

The reference toolkit stops at the raw spectrum (main/main.cc:186-208);
this sits on top of the same stft/istft pipeline. Static-shape discipline:
the sliding median is `k` statically-shifted copies stacked on a new axis
and reduced with `jnp.median` — no dynamic windows, no data-dependent
control flow, one jit for the whole separate-and-invert program. The
k-fold stack grows linearly with signal length (~715 MB f32 for one
minute at defaults), so beyond a 128 MB cap it is computed in `lax.map`
chunks along a non-filtered axis; the sort lowers to XLA's vectorized
bitonic network either way.

Boundary handling is edge-replication (pad mode "edge"): a median across
an edge-replicated window never invents energy that was not present,
which keeps the masks conservative at the signal boundaries.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .core.types import StftConfig

__all__ = ["hpss", "hpss_masks", "harmonic", "percussive"]


# Cap on the stacked intermediate's element count (32 M f32 = 128 MB).
# Beyond it the median is computed in chunks along a non-filtered axis —
# a naive full stack for one minute of audio at the default HPSS config is
# ~715 MB (frames x bins x kernel f32) and grows linearly with length.
_MEDIAN_STACK_ELEMS = 32 * 1024 * 1024


def _sliding_median(x: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Median over a centered length-`size` window along `axis` (odd size;
    edge-replicated boundaries). Static shapes: the window is a stack of
    `size` shifted slices. When the stack would exceed
    `_MEDIAN_STACK_ELEMS`, the input is processed in `lax.map` chunks
    along its largest non-filtered axis (positions there are independent
    of the median window), bounding peak memory at O(cap) regardless of
    signal length."""
    if size < 1 or size % 2 == 0:
        raise ValueError(f"median size must be odd and >= 1, got {size}")
    if size == 1:
        return x
    axis = axis % x.ndim
    half = size // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (half, half)
    xp = jnp.pad(x, pad, mode="edge")
    n = x.shape[axis]

    def med(block: jnp.ndarray, a: int) -> jnp.ndarray:
        shifts = [
            jax.lax.slice_in_dim(block, k, k + n, axis=a) for k in range(size)
        ]
        return jnp.median(jnp.stack(shifts, axis=-1), axis=-1)

    if x.size * size <= _MEDIAN_STACK_ELEMS or x.ndim == 1:
        return med(xp, axis)

    other = max(
        (d for d in range(x.ndim) if d != axis), key=lambda d: x.shape[d]
    )
    per_slice = (x.size // x.shape[other]) * size
    chunk = max(1, _MEDIAN_STACK_ELEMS // per_slice)
    if chunk >= x.shape[other]:
        return med(xp, axis)
    xm = jnp.moveaxis(xp, other, 0)  # chunked axis leading
    a_moved = axis + 1 if axis < other else axis
    n_other = xm.shape[0]
    n_blocks = -(-n_other // chunk)
    xm = jnp.pad(
        xm, [(0, n_blocks * chunk - n_other)] + [(0, 0)] * (xm.ndim - 1)
    )
    blocks = xm.reshape((n_blocks, chunk) + xm.shape[1:])
    out = jax.lax.map(lambda b: med(b, a_moved), blocks)
    out = out.reshape((n_blocks * chunk,) + out.shape[2:])[:n_other]
    return jnp.moveaxis(out, 0, other)


def hpss_masks(
    power: jnp.ndarray,
    kernel_harm: int = 31,
    kernel_perc: int = 31,
    mask_power: float = 2.0,
    margin_harm: float = 1.0,
    margin_perc: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Soft HPSS masks from a `[..., F, K]` power (or magnitude)
    spectrogram with frames on axis -2 and bins on axis -1.

    `H` = median over `kernel_harm` frames (per bin), `P` = median over
    `kernel_perc` bins (per frame); the masks are the Wiener-style ratio

        mask_h = H^p / (H^p + (margin_h * P)^p)
        mask_p = P^p / (P^p + (margin_p * H)^p)

    With margins of 1 the masks sum to 1 (a complete decomposition);
    margins > 1 demand a dominance margin and leave a discarded residual,
    trading completeness for isolation (Driedger et al. 2014).
    """
    if margin_harm < 1.0 or margin_perc < 1.0:
        raise ValueError("margins must be >= 1")
    h = _sliding_median(power, kernel_harm, axis=-2)
    p = _sliding_median(power, kernel_perc, axis=-1)
    tiny = jnp.finfo(power.dtype).tiny
    hp = jnp.power(jnp.maximum(h, 0.0), mask_power)
    pp = jnp.power(jnp.maximum(p, 0.0), mask_power)
    mh = hp / (hp + jnp.power(margin_harm, mask_power) * pp + tiny)
    mp = pp / (pp + jnp.power(margin_perc, mask_power) * hp + tiny)
    return mh, mp


@partial(jax.jit, static_argnames=(
    "cfg", "kernel_harm", "kernel_perc", "mask_power",
    "margin_harm", "margin_perc"))
def hpss(
    signal: jnp.ndarray,
    cfg: StftConfig,
    kernel_harm: int = 31,
    kernel_perc: int = 31,
    mask_power: float = 2.0,
    margin_harm: float = 1.0,
    margin_perc: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Separate `[..., T]` audio into `(harmonic, percussive)` parts of the
    same length: STFT -> median masks on |X|^2 -> masked iSTFTs, one jit.

    With unit margins the two parts sum to the stft round trip of the
    input (masks sum to 1 bin-wise), so `harmonic + percussive` matches
    the input to round-trip accuracy (> 60 dB on the default pipeline).
    """
    from .pipeline import istft, stft

    x = jnp.asarray(signal, jnp.float32)
    spec = stft(x, cfg)  # [..., F, K] complex, inside jit only
    mh, mp = hpss_masks(
        jnp.abs(spec) ** 2, kernel_harm, kernel_perc,
        mask_power, margin_harm, margin_perc,
    )
    length = x.shape[-1]
    return (
        istft(spec * mh, cfg, length=length),
        istft(spec * mp, cfg, length=length),
    )


def harmonic(signal: jnp.ndarray, cfg: StftConfig, **kwargs) -> jnp.ndarray:
    """The harmonic part of `hpss` (same keyword options)."""
    return hpss(signal, cfg, **kwargs)[0]


def percussive(signal: jnp.ndarray, cfg: StftConfig, **kwargs) -> jnp.ndarray:
    """The percussive part of `hpss` (same keyword options)."""
    return hpss(signal, cfg, **kwargs)[1]
