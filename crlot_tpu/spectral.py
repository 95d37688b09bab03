"""Spectral-domain processing ops for the STFT pipeline's process stage.

The reference's e2e pipeline has an identity processing hook
(bench/e2e_benchmark.cc:161-163 "(identity spectral processing)"); these are
the batteries this build ships for that hook: pure functions
`spec [..., F, K] -> spec` composable into `round_trip(spectral_fn=...)`.
All are elementwise/banded and fuse into the surrounding FFT matmuls.

Fast-path protocols (all optional attributes on a spectral fn, honored by
the single-device, streaming, and sharded pipelines):
- `per_bin_gains(nfft) -> f64 [K] | None`: fixed REAL per-bin gains;
- `per_bin_response(nfft) -> complex [K] | None`: any fixed per-bin curve —
  composes with the DFT bases into ONE [N, N] round-trip matmul
  (fft.matmul_backend.roundtrip_composed_matmul);
- `packed(re, im) -> (re, im)`: the op on split Re/Im planes, letting the
  tiled matmul path skip complex64 interleave for NONLINEAR ops.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
import numpy as np


def gain(g: float) -> Callable:
    """Uniform complex gain."""

    def f(spec):
        return spec * jnp.asarray(g, dtype=spec.real.dtype)

    f.per_bin_gains = lambda nfft: np.full(nfft // 2 + 1, g, np.float64)
    f.packed = lambda re, im: (re * jnp.float32(g), im * jnp.float32(g))
    return f


def per_bin_filter(h: jnp.ndarray) -> Callable:
    """Multiply every frame by a fixed complex (or real) frequency response
    h[K] — an FFT-domain FIR filter (fast convolution)."""

    def f(spec):
        return spec * jnp.asarray(h)[..., None, :]

    hn = np.asarray(h)
    if hn.ndim == 1 and np.isrealobj(hn):
        f.per_bin_gains = lambda nfft: (
            hn.astype(np.float64) if len(hn) == nfft // 2 + 1 else None
        )
    if hn.ndim == 1:
        # complex responses compose into the one-matmul round-trip too
        f.per_bin_response = lambda nfft: (
            hn.astype(np.complex128) if len(hn) == nfft // 2 + 1 else None
        )

        hr = jnp.asarray(np.real(hn).astype(np.float32))
        hi = jnp.asarray(np.imag(hn).astype(np.float32))

        def packed(re, im):
            return re * hr - im * hi, re * hi + im * hr

        f.packed = packed
    return f


def fir_frequency_response(taps: np.ndarray, nfft: int) -> np.ndarray:
    """Frequency response of an FIR filter at the pipeline's bin grid.

    Note: per-frame multiplication implements CIRCULAR convolution per frame;
    with windowed frames and hop <= nfft - len(taps) the wrap-around is
    attenuated to the window floor (standard weighted-OLA filtering).
    """
    t = np.zeros(nfft, dtype=np.float64)
    t[: len(taps)] = np.asarray(taps, dtype=np.float64)
    return np.fft.rfft(t).astype(np.complex64)


def magnitude(spec: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(spec)


def power_db(spec: jnp.ndarray, floor_db: float = -120.0) -> jnp.ndarray:
    p = jnp.square(jnp.abs(spec))
    floor = 10.0 ** (floor_db / 10.0)
    return 10.0 * jnp.log10(jnp.maximum(p, floor))


def noise_gate(threshold_db: float, attenuation_db: float = -60.0) -> Callable:
    """Attenuate bins whose power is below `threshold_db` (relative to full
    scale): a simple spectral gate."""
    thresh = 10.0 ** (threshold_db / 10.0)
    att = 10.0 ** (attenuation_db / 20.0)

    def f(spec):
        p = jnp.square(jnp.abs(spec))
        return jnp.where(p >= thresh, spec, spec * att)

    def packed(re, im):
        p = re * re + im * im
        s = jnp.where(p >= thresh, 1.0, att).astype(re.dtype)
        return re * s, im * s

    f.packed = packed
    return f


def spectral_subtraction(noise_mag: jnp.ndarray, alpha: float = 1.0,
                         floor: float = 0.0) -> Callable:
    """Classic magnitude spectral subtraction with a spectral floor:
    |Y| = max(|X| - alpha*|N|, floor*|X|), phase preserved."""

    def _scale(mag):
        nm = jnp.asarray(noise_mag)[..., None, :]
        new_mag = jnp.maximum(mag - alpha * nm, floor * mag)
        return jnp.where(mag > 0, new_mag / jnp.maximum(mag, 1e-20), 0.0)

    def f(spec):
        return spec * _scale(jnp.abs(spec))

    def packed(re, im):
        s = _scale(jnp.sqrt(re * re + im * im))
        return re * s, im * s

    f.packed = packed
    return f


def band_gain(edges_hz: Sequence[float], gains: Sequence[float],
              sample_rate: int, nfft: int) -> Callable:
    """Piecewise-constant graphic-EQ style band gains.

    edges_hz: ascending band edges (len B-1); gains: per-band linear gains
    (len B). Bin k at k*sr/nfft Hz gets the gain of its band.
    """
    if len(gains) != len(edges_hz) + 1:
        raise ValueError("need len(gains) == len(edges_hz) + 1")
    freqs = np.arange(nfft // 2 + 1) * (sample_rate / nfft)
    g = np.asarray(gains, dtype=np.float64)[np.searchsorted(edges_hz, freqs)]
    gj = jnp.asarray(g.astype(np.float32))

    def f(spec):
        return spec * gj[..., None, :]

    f.per_bin_gains = lambda n: g if n == nfft else None
    f.packed = lambda re, im: (re * gj, im * gj)
    return f


def compose(*fns: Callable) -> Callable:
    """Chain spectral fns left-to-right."""

    def f(spec):
        for fn in fns:
            spec = fn(spec)
        return spec

    def _gains(nfft):
        total = np.ones(nfft // 2 + 1, np.float64)
        for fn in fns:
            gfn = getattr(fn, "per_bin_gains", None)
            g = gfn(nfft) if gfn is not None else None
            if g is None:
                return None
            total = total * g
        return total

    def _response(nfft):
        total = np.ones(nfft // 2 + 1, np.complex128)
        for fn in fns:
            rfn = getattr(fn, "per_bin_response", None) or getattr(
                fn, "per_bin_gains", None
            )
            r = rfn(nfft) if rfn is not None else None
            if r is None:
                return None
            total = total * r
        return total

    f.per_bin_gains = _gains
    f.per_bin_response = _response
    if all(hasattr(fn, "packed") for fn in fns):

        def _packed(re, im):
            for fn in fns:
                re, im = fn.packed(re, im)
            return re, im

        f.packed = _packed
    return f


def resolve_per_bin_gains(spectral_fn, nfft: int):
    """The packed-fast-path protocol: a spectral fn that is a fixed REAL
    per-bin multiply exposes `.per_bin_gains(nfft) -> f64 [K] | None`; the
    pipeline folds such gains into the inverse DFT constants and keeps the
    packed (no-complex) round-trip — fixed EQ at identity-round-trip cost.
    Returns the gains or None (not applicable / not foldable)."""
    if spectral_fn is None:
        return None
    gfn = getattr(spectral_fn, "per_bin_gains", None)
    if gfn is None:
        return None
    g = gfn(nfft)
    if g is None:
        return None
    g = np.asarray(g, np.float64)
    if g.shape != (nfft // 2 + 1,) or not np.isfinite(g).all():
        return None
    return g


def resolve_per_bin_response(spectral_fn, nfft: int):
    """Like resolve_per_bin_gains but for GENERAL fixed responses: any
    spectral fn that is a fixed per-bin multiply by a real-or-complex
    curve (EQ, FIR response, fractional delay, allpass) exposes
    `.per_bin_response(nfft) -> complex [K] | None` (real `.per_bin_gains`
    qualifies too). Such a response composes with the DFT bases into one
    [N, N] round-trip matrix (matmul_backend.roundtrip_composed_matmul).
    Returns complex128 [K] or None."""
    if spectral_fn is None:
        return None
    rfn = getattr(spectral_fn, "per_bin_response", None)
    r = rfn(nfft) if rfn is not None else None
    if r is None:
        g = resolve_per_bin_gains(spectral_fn, nfft)
        return None if g is None else g.astype(np.complex128)
    r = np.asarray(r, np.complex128)
    if r.shape != (nfft // 2 + 1,) or not np.isfinite(r).all():
        return None
    return r
