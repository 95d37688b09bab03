"""Welch power-spectral-density estimation on the STFT pipeline.

A toolkit staple built directly on the framed STFT: average the
per-frame periodograms |X_f[k]|^2 with the standard window-power and
sampling normalization (matches scipy.signal.welch with the same window,
nperseg = frame_size, noverlap = frame_size - hop_size, detrend=False).

Everything runs in one jit: framing, the DFT, the magnitude square, and
the frame average; only the real PSD leaves it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import StftConfig


@partial(jax.jit, static_argnames=("cfg", "fs", "scaling"))
def welch_psd(
    signal: jnp.ndarray,
    cfg: StftConfig,
    fs: float = 1.0,
    scaling: str = "density",
) -> jnp.ndarray:
    """Welch PSD of `[..., T]` -> `[..., nfft//2+1]`.

    `scaling="density"` gives V^2/Hz (divide by fs * sum(w^2));
    `scaling="spectrum"` gives V^2 (divide by sum(w)^2). One-sided:
    interior bins are doubled. `cfg.center` is ignored (Welch segments
    never extend past the data). Use `welch_freqs(cfg, fs)` for the bin
    frequencies.
    """
    if scaling not in ("density", "spectrum"):
        raise ValueError(f"unknown scaling: {scaling}")
    import dataclasses

    from .pipeline import _window_f64, stft

    cfg_u = dataclasses.replace(cfg, center=False)
    signal = jnp.asarray(signal)
    _require_frames(cfg_u, signal.shape[-1])
    spec = stft(signal, cfg_u)  # [..., F, K]
    p = jnp.mean(
        jnp.square(spec.real) + jnp.square(spec.imag), axis=-2
    )
    w = _window_f64(cfg_u)
    if scaling == "density":
        norm = 1.0 / (fs * float(np.sum(w * w)))
    else:
        norm = 1.0 / float(np.sum(w)) ** 2
    p = p * norm
    # One-sided doubling: DC appears once always; the last rfft bin is
    # Nyquist (appears once) only for even frame_size — for odd sizes scipy
    # doubles it too. StftConfig currently enforces even frame_size, but the
    # scale is parity-aware so the scipy contract survives any relaxation.
    kk = cfg.frame_size // 2 + 1
    last = kk if cfg.frame_size % 2 else kk - 1
    scale = jnp.ones(kk, jnp.float32).at[1:last].set(2.0)
    return p * scale


def _require_frames(cfg: StftConfig, signal_len: int) -> None:
    """Welch needs >= 1 full segment; a zero-frame mean is silently NaN
    (scipy adapts nperseg and warns instead — we fail loudly). Host-side
    shape check, so it costs nothing inside jit."""
    if cfg.frame_spec.num_frames(signal_len) == 0:
        raise ValueError(
            f"signal length {signal_len} yields zero Welch segments for "
            f"frame_size={cfg.frame_size} (need >= frame_size samples)"
        )


def welch_freqs(cfg: StftConfig, fs: float = 1.0) -> np.ndarray:
    """Bin center frequencies for `welch_psd` (host numpy)."""
    return np.fft.rfftfreq(cfg.frame_size, d=1.0 / fs)


@partial(jax.jit, static_argnames=("cfg",))
def _welch_spectra(x, y, cfg: StftConfig):
    """Frame-averaged auto/auto/cross spectra (unnormalized)."""
    import dataclasses

    from .pipeline import stft

    cfg_u = dataclasses.replace(cfg, center=False)
    x, y = jnp.asarray(x), jnp.asarray(y)
    _require_frames(cfg_u, x.shape[-1])
    _require_frames(cfg_u, y.shape[-1])
    sx = stft(x, cfg_u)
    sy = stft(y, cfg_u)
    pxx = jnp.mean(jnp.square(sx.real) + jnp.square(sx.imag), axis=-2)
    pyy = jnp.mean(jnp.square(sy.real) + jnp.square(sy.imag), axis=-2)
    # conj(X) * Y, averaged over frames; returned as (re, im) real planes
    # so no complex leaves the jit.
    pxy_re = jnp.mean(sx.real * sy.real + sx.imag * sy.imag, axis=-2)
    pxy_im = jnp.mean(sx.real * sy.imag - sx.imag * sy.real, axis=-2)
    return pxx, pyy, pxy_re, pxy_im


def coherence(
    x: jnp.ndarray, y: jnp.ndarray, cfg: StftConfig, eps: float = 1e-30
) -> jnp.ndarray:
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx * Pyy) of two
    `[..., T]` signals -> `[..., nfft//2+1]` in [0, 1] (matches
    scipy.signal.coherence with the same window/overlap, detrend=False).
    Needs overlap (hop < frame_size): with a single averaged segment the
    estimate degenerates to 1."""
    pxx, pyy, pxy_re, pxy_im = _welch_spectra(x, y, cfg)
    num = jnp.square(pxy_re) + jnp.square(pxy_im)
    return num / jnp.maximum(pxx * pyy, eps)
