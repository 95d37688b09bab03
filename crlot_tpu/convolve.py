"""Exact 1-D FIR convolution as hop-block Toeplitz matmuls.

Direct convolution without `lax.conv` or FFT overlap-add (which needs length
padding and complex intermediates): the linear convolution is blocked like
`fft.matmul_backend.roundtrip_composed_blocked` (shared runtime:
`hopblock_apply`): each output hop-block is one row of a
[B, M*hop] x [M*hop, hop] matmul whose kernel is the taps laid out on the
Toeplitz diagonals — exact (no circular wrap) and entirely dense matmuls.
MACs/sample = ceil((L-1)/hop + 1)*hop ~= L + hop for L taps.

Modes follow numpy.convolve: full (T+L-1), same (max(T, L), centered),
valid (max-min+1) — including the L > len(x) orientations.

Matmuls run at `fft.matmul_backend.PRECISION` (true f32).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .fft.matmul_backend import hopblock_apply

_HOP = 256  # lane-aligned output block (2 x 128)


# Bounded: each entry pins ~(L+hop)*hop f32 of host memory (~256x the taps),
# so per-call dynamic filters in a long-lived process must evict.
@lru_cache(maxsize=64)
def _toeplitz_kernel(taps_bytes: bytes, hop: int):
    """[M*hop, hop] kernel: K[tau, s] = taps[s - tau + (M-1)*hop]."""
    taps = np.frombuffer(taps_bytes, dtype=np.float64)
    ll = len(taps)
    mg = -(-(ll - 1) // hop) + 1 if ll > 1 else 1
    k = np.zeros((mg * hop, hop), np.float64)
    off = (mg - 1) * hop
    tau = np.arange(mg * hop)[:, None]
    s = np.arange(hop)[None, :]
    j = s - tau + off
    inside = (j >= 0) & (j < ll)
    k[inside] = taps[j[inside]]
    return np.ascontiguousarray(k.astype(np.float32))


def convolve(
    x: jnp.ndarray,
    taps,
    mode: str = "full",
    precision=None,
) -> jnp.ndarray:
    """Linear convolution of `[..., T]` with 1-D `taps` (len L <= a few
    thousand — kernel memory is ~L*hop floats). Matches numpy.convolve
    semantics for `mode` in {"full", "same", "valid"}."""
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    if isinstance(taps, jax.core.Tracer):
        raise TypeError(
            "taps must be a concrete host array (the Toeplitz kernel is "
            "built in numpy at call time); do not pass a traced value — "
            "close over the taps or mark them static instead"
        )
    taps64 = np.asarray(taps, np.float64)
    if taps64.ndim != 1 or taps64.size == 0:
        raise ValueError("taps must be a non-empty 1-D array")
    x = jnp.asarray(x, jnp.float32)
    t = x.shape[-1]
    ll = taps64.size
    hop = _HOP
    kern = _toeplitz_kernel(taps64.tobytes(), hop)
    n_full = t + ll - 1
    # Left halo = the kernel's look-back span (mg-1 blocks).
    left = kern.shape[0] - hop
    full = hopblock_apply(x, kern, hop, n_full, left, precision)
    if mode == "full":
        return full
    lo, hi = min(t, ll), max(t, ll)
    if mode == "same":  # numpy: length max(T, L), centered
        start = (lo - 1) // 2
        return full[..., start : start + hi]
    return full[..., lo - 1 : hi]  # valid: length max - min + 1
