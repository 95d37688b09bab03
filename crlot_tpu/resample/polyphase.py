"""Polyphase FIR resampler (replaces the reference demo's r8brain usage).

Reference: main/main.cc:238-352 streams r8brain's CDSPResampler in 4096-sample
chunks; BASELINE.json replaces it with a polyphase FIR resampler on the
device. Design per SURVEY.md §7 step 6: windowed-sinc (Kaiser) designed in
float64 on the host, executed as ONE grouped Toeplitz matmul (G output
blocks per matmul row), the matrix form of a polyphase filter bank.

Math. For rational rate L/M (reduced), with h a lowpass at the L-upsampled
rate (gain L, group delay G ticks, h centered):

    y[m] = sum_t h[t*L + p_m] * x[n_m - t],   a_m = m*M + G,
           p_m = a_m mod L,  n_m = a_m div L.

Outputs are processed in blocks of L: within a block the phase pattern
(p_i, d_i) for i in [0, L) is fixed, so the whole resampler collapses to a
kernel bank K[L, W] and one conv with stride M:

    y[b*L + i] = sum_w K[i, w] * x_padded[b*M + w].
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a target stopband attenuation (dB)."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def design_lowpass(
    l: int,
    m: int,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
    rolloff: float = 0.1,
) -> np.ndarray:
    """Centered Kaiser-windowed-sinc lowpass for L/M resampling, float64.

    The stopband edge sits exactly at the output Nyquist (pi/max(L,M) at the
    L-upsampled rate) with the transition band `rolloff * Nyquist` wide taken
    out of the passband (passband to (1-rolloff)*Nyquist). With
    taps_per_phase=None the length is derived from the Kaiser design formula
    N = (A - 7.95) / (2.285 * delta_omega) so `atten_db` is actually met;
    passing taps_per_phase overrides (length = taps_per_phase * max(L, M)).
    Passband gain L compensates zero-stuffing. Odd length, group delay = half.
    """
    mx = max(l, m)
    if taps_per_phase is None:
        delta_omega = rolloff * np.pi / mx
        n_total = int(np.ceil((atten_db - 7.95) / (2.285 * delta_omega)))
        half = max(n_total // 2, mx)
    else:
        half = (taps_per_phase * mx) // 2
    n = 2 * half + 1
    k = np.arange(n, dtype=np.float64) - half
    fc = (1.0 - rolloff / 2.0) / mx  # cutoff centered in the transition band
    h = fc * np.sinc(fc * k)
    h *= np.kaiser(n, kaiser_beta(atten_db))
    # Normalize DC gain to exactly L (sum of every Lth tap ~ 1/L each).
    h *= l / h.sum()
    return h


@lru_cache(maxsize=None)
def _kernel_bank(
    l: int, m: int, taps_per_phase: int | None, atten_db: float
) -> Tuple[np.ndarray, int, int]:
    """Build the [L, W] kernel bank; returns (K f32, tau_min, W)."""
    h = design_lowpass(l, m, taps_per_phase, atten_db)
    half = (len(h) - 1) // 2
    tp = -(-len(h) // l)  # taps per phase after zero-pad
    hpad = np.zeros(tp * l, dtype=np.float64)
    hpad[: len(h)] = h

    a = np.arange(l) * m + half  # a_i = i*M + G
    p = a % l
    d = a // l
    tau_min = int(d.min()) - (tp - 1)
    tau_max = int(d.max())
    w = tau_max - tau_min + 1
    bank = np.zeros((l, w), dtype=np.float64)
    for i in range(l):
        for t in range(tp):
            tau = int(d[i]) - t
            bank[i, tau - tau_min] = hpad[t * l + p[i]]
    return bank.astype(np.float32), tau_min, w


@lru_cache(maxsize=32)
def _grouped_kernel(
    l: int, m: int, taps_per_phase: int | None, atten_db: float, g: int
) -> Tuple[np.ndarray, int, int]:
    """Toeplitz expansion of the kernel bank over G consecutive L-blocks:
    K2[r, j*L + i] = bank[i, r - j*M], span = (G-1)*M + W. One output row
    covers G*L output samples from span input samples — the resampler
    becomes a single well-shaped [B, span] x [span, G*L] matmul.
    Returns (K2 f32, tau_min, span)."""
    bank, tau_min, w = _kernel_bank(l, m, taps_per_phase, atten_db)
    span = (g - 1) * m + w
    k2 = np.zeros((span, g * l), dtype=np.float32)
    for j in range(g):
        k2[j * m : j * m + w, j * l : (j + 1) * l] = bank.T
    return k2, tau_min, span


def _group_count(l: int) -> int:
    """Blocks per matmul row: target ~256-512 output lanes per row."""
    return max(1, -(-256 // l))


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _resample_impl(
    x: jnp.ndarray,  # [C, T]
    l: int,
    m: int,
    n_out: int,
    taps_per_phase: int | None,
    atten_db: float,
) -> jnp.ndarray:
    """Polyphase resample as ONE grouped Toeplitz matmul.

    The matmul form is shape-robust: y[(b*G+j)*L + i] =
    sum_r X[b, r] * K2[r, j*L+i] with X[b] = x_padded[b*G*M : +span]."""
    g = _group_count(l)
    k2_np, tau_min, span = _grouped_kernel(l, m, taps_per_phase, atten_db, g)
    k2 = jnp.asarray(k2_np)  # [span, G*L]
    channels, t_in = x.shape
    row = g * l
    blocks = -(-n_out // row)
    # x_padded[j] must equal x[j + tau_min]; last window ends at
    # (blocks-1)*G*M + span - 1 (in padded coords).
    pad_left = -tau_min
    need = (blocks - 1) * g * m + span
    pad_right = max(0, need - (t_in + pad_left))
    xp = jnp.pad(x, ((0, 0), (pad_left, pad_right)))
    idx = jnp.arange(blocks)[:, None] * (g * m) + jnp.arange(span)[None, :]
    frames = jnp.take(xp, idx, axis=-1)  # [C, B, span]
    # True f32: an unspecified f32 dot runs in TF32 on the GPU, 72 dB from
    # scipy's float64 resample_poly on an H100 instead of 133 dB.
    y = jnp.einsum(
        "cbs,sr->cbr", frames, k2, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(channels, blocks * row)
    return y[:, :n_out]


def output_length(n_in: int, sr_in: int, sr_out: int) -> int:
    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    return -(-n_in * l // m)  # ceil(n*L/M), matches scipy.resample_poly


def resample(
    x: jnp.ndarray,
    sr_in: int,
    sr_out: int,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
) -> jnp.ndarray:
    """Resample `[..., T]` from sr_in to sr_out (zero-phase, ceil(T*L/M) out).

    Matches scipy.signal.resample_poly(x, L, M, window=<same filter>) on the
    interior; edges use zero padding (same as scipy).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError("sample rates must be > 0")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected [T] or [C, T], got shape {x.shape}")
    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    if l == m:
        return x[0] if squeeze else x
    n_out = -(-x.shape[-1] * l // m)
    y = _resample_impl(x, l, m, n_out, taps_per_phase, atten_db)
    return y[0] if squeeze else y


def resample_chunked(
    x: np.ndarray,
    sr_in: int,
    sr_out: int,
    chunk: int = 65536,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
) -> np.ndarray:
    """Streaming variant: process long host signals in overlapping chunks
    (the r8brain demo's 4096-sample chunk loop, main/main.cc:257-287, with
    device-sized chunks). Output is identical to one-shot `resample`.
    """
    x = np.asarray(x, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    if l == m:
        return x[0] if squeeze else x
    if chunk % m != 0:
        chunk = -(-chunk // m) * m  # input chunks must be M-aligned
    t_in = x.shape[-1]
    n_out = -(-t_in * l // m)
    # History needed so interior windows see real samples (W input samples),
    # rounded up to a multiple of M so every chunk starts at polyphase
    # phase 0 (gcd(L,M)=1: outputs align only at M-multiples of input).
    _, _tau_min, w = _kernel_bank(l, m, taps_per_phase, atten_db)
    hist = -(-(w + m) // m) * m
    out = np.zeros((x.shape[0], n_out), dtype=np.float32)
    for start in range(0, t_in, chunk):
        lo = max(0, start - hist)  # multiple of m (chunk and hist are)
        hi = min(t_in, start + chunk + hist)
        seg = jnp.asarray(x[:, lo:hi])
        y = np.asarray(
            _resample_impl(
                seg, l, m, -(-(hi - lo) * l // m), taps_per_phase, atten_db
            )
        )
        # Global output j maps to local j - lo*L/M (exact: m | lo).
        out_lo = -(-start * l // m)
        out_hi = min(n_out, -(-min(t_in, start + chunk) * l // m))
        local0 = out_lo - lo * l // m
        out[:, out_lo:out_hi] = y[:, local0 : local0 + (out_hi - out_lo)]
    return out[0] if squeeze else out
