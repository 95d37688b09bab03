"""Spectral features on the framed STFT: mel filterbank / mel
spectrogram / MFCC, the classic spectral descriptors, analytic-signal
utilities, and the inversion path back to audio (mfcc_to_mel ->
mel_to_linear NNLS -> Griffin-Lim).

The reference toolkit stops at the raw spectrum (its demo prints a top-10
peak table, main/main.cc:186-208); a framework user coming from it for
analysis work needs the standard feature stack on top. Everything here is
matmul-shaped on purpose: a mel filterbank is a `[K, n_mels]` matrix applied
to the power spectrogram, and the MFCC's DCT-II is another constant matrix —
both are one matmul batched over frames.

Design-time constants (filterbank, DCT basis) follow the repo convention:
computed in float64 numpy, cached by key, cast to f32 (see
window/windows.py). Features consume |X|^2 computed in-jit.

Conventions match librosa/HTK where noted so oracles are unambiguous:
- mel scale: "slaney" (librosa default; linear below 1 kHz, log above) or
  "htk" (2595 * log10(1 + f/700)).
- filterbank norm: "slaney" (equal-area) or None (unit peak).
- MFCC: DCT-II with orthonormal scaling over log-mel in dB (10*log10).
"""

from __future__ import annotations

import threading
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import StftConfig

_CACHE: Dict[Tuple, np.ndarray] = {}
_CACHE_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# mel scale + filterbank design (host, float64)
# ---------------------------------------------------------------------------

def hz_to_mel(f, htk: bool = False):
    """Hz -> mel. `htk=True` uses 2595*log10(1+f/700); default is the
    Slaney scale (linear below 1 kHz: f/66.67 mel; log above: +log-spaced
    at 27 mel per ln(6.4) octave-ish step)."""
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(m, htk: bool = False):
    """Inverse of `hz_to_mel`."""
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3.0
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs = np.where(
        log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )
    return freqs


def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank `[n_mels, n_fft//2 + 1]` (float32).

    Filters are triangles with vertices at `n_mels + 2` mel-equispaced
    frequencies in [fmin, fmax]; `norm="slaney"` scales each triangle to
    unit area (2 / bandwidth), `norm=None` leaves unit peaks. Designed in
    float64, cached, cast f32 — usable directly as a jit constant.
    """
    if fmax is None:
        fmax = sr / 2.0
    if not (0.0 <= fmin < fmax <= sr / 2.0 + 1e-9):
        raise ValueError(f"need 0 <= fmin < fmax <= sr/2, got [{fmin}, {fmax}]")
    if n_mels < 1:
        raise ValueError("n_mels must be >= 1")
    if norm not in (None, "slaney"):
        raise ValueError(f"unknown filterbank norm: {norm!r}")
    key = ("melfb", float(sr), int(n_fft), int(n_mels), float(fmin),
           float(fmax), bool(htk), norm)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit

    fft_freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)  # [K] f64
    mel_pts = np.linspace(
        hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2
    )
    hz_pts = mel_to_hz(mel_pts, htk)  # [n_mels + 2]

    # Triangle m rises hz_pts[m] -> hz_pts[m+1], falls to hz_pts[m+2].
    lower = (fft_freqs[None, :] - hz_pts[:-2, None]) / np.maximum(
        hz_pts[1:-1, None] - hz_pts[:-2, None], 1e-30
    )
    upper = (hz_pts[2:, None] - fft_freqs[None, :]) / np.maximum(
        hz_pts[2:, None] - hz_pts[1:-1, None], 1e-30
    )
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    fb = np.ascontiguousarray(fb.astype(np.float32))
    fb.setflags(write=False)
    with _CACHE_LOCK:
        _CACHE[key] = fb
    return fb


def _dct_ii_ortho(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix `[n_out, n_in]` (float32, cached).
    Matches scipy.fft.dct(type=2, norm="ortho") applied along the mel axis.
    """
    key = ("dct2", int(n_out), int(n_in))
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    k = np.arange(n_out, dtype=np.float64)[:, None]
    n = np.arange(n_in, dtype=np.float64)[None, :]
    mat = np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    mat *= np.sqrt(2.0 / n_in)
    mat[0] *= 1.0 / np.sqrt(2.0)
    mat = np.ascontiguousarray(mat.astype(np.float32))
    mat.setflags(write=False)
    with _CACHE_LOCK:
        _CACHE[key] = mat
    return mat


# ---------------------------------------------------------------------------
# jitted feature extractors
# ---------------------------------------------------------------------------

def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """f32 matmul in true f32: an unspecified f32 dot runs in TF32 on the
    GPU (mel power 73 dB from float64 on an H100 instead of 140 dB)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _power_spectrogram(signal: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """|STFT|^2 `[..., F, K]` — real output so nothing complex leaves jit."""
    from .pipeline import stft

    spec = stft(signal, cfg)
    return jnp.square(spec.real) + jnp.square(spec.imag)


@partial(jax.jit, static_argnames=(
    "cfg", "sr", "n_mels", "fmin", "fmax", "htk", "norm"))
def mel_spectrogram(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> jnp.ndarray:
    """Mel power spectrogram `[..., T] -> [..., F, n_mels]`.

    One jit: framing + matmul DFT + |.|^2 + the `[K, n_mels]` filterbank
    matmul (batched over frames).
    """
    fb = mel_filterbank(sr, cfg.frame_size, n_mels, fmin, fmax, htk, norm)
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    return _mm(p, jnp.asarray(fb).T)


def power_to_db(p: jnp.ndarray, floor_db: float = -100.0,
                ref: float = 1.0) -> jnp.ndarray:
    """10*log10(p/ref), floored at `floor_db` (no -inf on silence)."""
    floor = 10.0 ** (floor_db / 10.0)
    return 10.0 * jnp.log10(jnp.maximum(p / ref, floor))


def amplitude_to_db(a: jnp.ndarray, floor_db: float = -100.0,
                    ref: float = 1.0) -> jnp.ndarray:
    """20*log10(|a|/ref), floored at `floor_db` (no -inf on silence)."""
    floor = 10.0 ** (floor_db / 20.0)
    return 20.0 * jnp.log10(jnp.maximum(jnp.abs(a) / ref, floor))


def db_to_power(db: jnp.ndarray, ref: float = 1.0) -> jnp.ndarray:
    """Inverse of `power_to_db` (above its floor): ref * 10^(db/10)."""
    return ref * 10.0 ** (jnp.asarray(db) / 10.0)


def db_to_amplitude(db: jnp.ndarray, ref: float = 1.0) -> jnp.ndarray:
    """Inverse of `amplitude_to_db` (above its floor): ref * 10^(db/20)."""
    return ref * 10.0 ** (jnp.asarray(db) / 20.0)


def magphase(spec: jnp.ndarray):
    """Split a complex spectrogram into (magnitude, unit-phasor) with
    `mag * phasor == spec`; zero bins get phasor 1 (not NaN)."""
    mag = jnp.abs(spec)
    phasor = jnp.where(
        mag > 0, spec / jnp.where(mag > 0, mag, 1.0),
        jnp.ones((), spec.dtype),
    )
    return mag, phasor


@partial(jax.jit, static_argnames=(
    "cfg", "sr", "n_mfcc", "n_mels", "fmin", "fmax", "htk", "norm",
    "floor_db"))
def mfcc(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_mfcc: int = 13,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    floor_db: float = -100.0,
) -> jnp.ndarray:
    """MFCCs `[..., T] -> [..., F, n_mfcc]`: orthonormal DCT-II of the
    dB log-mel spectrogram (librosa convention)."""
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc ({n_mfcc}) must be <= n_mels ({n_mels})")
    mel = mel_spectrogram(signal, cfg, sr, n_mels, fmin, fmax, htk, norm)
    logmel = power_to_db(mel, floor_db)
    dct = _dct_ii_ortho(n_mfcc, n_mels)
    return _mm(logmel, jnp.asarray(dct).T)


# ---------------------------------------------------------------------------
# spectral descriptors (per frame)
# ---------------------------------------------------------------------------

def _freqs(cfg: StftConfig, sr: float) -> jnp.ndarray:
    return jnp.asarray(
        np.fft.rfftfreq(cfg.frame_size, d=1.0 / sr).astype(np.float32)
    )


@partial(jax.jit, static_argnames=("cfg", "sr"))
def spectral_centroid(signal: jnp.ndarray, cfg: StftConfig,
                      sr: float) -> jnp.ndarray:
    """Magnitude-weighted mean frequency per frame `[..., T] -> [..., F]`
    (Hz). Silent frames return 0."""
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    mag = jnp.sqrt(p)
    f = _freqs(cfg, sr)
    num = jnp.sum(mag * f, axis=-1)
    den = jnp.sum(mag, axis=-1)
    return jnp.where(den > 0, num / jnp.maximum(den, 1e-30), 0.0)


@partial(jax.jit, static_argnames=("cfg", "sr"))
def spectral_bandwidth(signal: jnp.ndarray, cfg: StftConfig,
                       sr: float) -> jnp.ndarray:
    """Magnitude-weighted std of frequency about the centroid, per frame
    (Hz). Silent frames return 0."""
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    mag = jnp.sqrt(p)
    f = _freqs(cfg, sr)
    den = jnp.maximum(jnp.sum(mag, axis=-1), 1e-30)
    cent = jnp.sum(mag * f, axis=-1) / den
    var = jnp.sum(mag * jnp.square(f - cent[..., None]), axis=-1) / den
    return jnp.where(
        jnp.sum(mag, axis=-1) > 0, jnp.sqrt(jnp.maximum(var, 0.0)), 0.0
    )


@partial(jax.jit, static_argnames=("cfg", "sr", "roll_percent"))
def spectral_rolloff(signal: jnp.ndarray, cfg: StftConfig, sr: float,
                     roll_percent: float = 0.85) -> jnp.ndarray:
    """Lowest frequency per frame below which `roll_percent` of the total
    spectral energy lies `[..., T] -> [..., F]` (Hz)."""
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    csum = jnp.cumsum(p, axis=-1)
    thresh = roll_percent * csum[..., -1:]
    f = _freqs(cfg, sr)
    # First bin where cumulative energy crosses the threshold: argmax over
    # the boolean (static shapes, no data-dependent control flow).
    idx = jnp.argmax(csum >= thresh, axis=-1)
    return f[idx]


def chroma_filterbank(
    sr: float,
    n_fft: int,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
) -> np.ndarray:
    """Chroma (pitch-class) filterbank `[n_chroma, n_fft//2 + 1]` (f32).

    Each FFT bin's fractional pitch p = n_chroma * log2(f / C0) (C0 =
    16.3516 Hz, so class 0 = C) is spread over classes with a wrapped
    Gaussian of width `sigma` semitones; bins below `fmin` are zeroed
    (no pitch class for DC/rumble). Columns are L1-normalized so a bin's
    energy is distributed, not amplified. Designed f64, cached.

    Resolution caveat: pitch-class labeling is only as fine as the FFT
    grid — reliable chroma for a pitch f needs bin spacing sr/n_fft well
    under a semitone (~f/17), e.g. n_fft >= 4096 at 48 kHz for notes
    below ~A3.
    """
    if n_chroma < 2:
        raise ValueError("n_chroma must be >= 2")
    key = ("chromafb", float(sr), int(n_fft), int(n_chroma), float(sigma),
           float(fmin))
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    c0 = 440.0 / 16.0 * (2.0 ** (-9.0 / 12.0))  # C0 = 16.3516 Hz
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)
    valid = freqs >= fmin
    p = np.zeros_like(freqs)
    p[valid] = n_chroma * np.log2(freqs[valid] / c0)
    classes = np.arange(n_chroma)[:, None]
    dist = (p[None, :] - classes) % n_chroma
    dist = np.minimum(dist, n_chroma - dist)  # wrapped distance
    fb = np.exp(-0.5 * (dist / sigma) ** 2)
    fb[:, ~valid] = 0.0
    col = fb.sum(axis=0, keepdims=True)
    fb = np.where(col > 0, fb / np.maximum(col, 1e-12), 0.0)
    fb = np.ascontiguousarray(fb.astype(np.float32))
    fb.setflags(write=False)
    with _CACHE_LOCK:
        _CACHE[key] = fb
    return fb


@partial(jax.jit, static_argnames=("cfg", "sr", "n_chroma", "sigma",
                                   "fmin"))
def chroma(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
) -> jnp.ndarray:
    """Chroma energy per frame `[..., T] -> [..., F, n_chroma]` (class 0 =
    C): the power spectrogram through the chroma filterbank matmul."""
    fb = chroma_filterbank(sr, cfg.frame_size, n_chroma, sigma, fmin)
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    return _mm(p, jnp.asarray(fb).T)


@partial(jax.jit, static_argnames=("width", "order"))
def delta(feat: jnp.ndarray, width: int = 9, order: int = 1) -> jnp.ndarray:
    """Regression delta of a feature track along the FRAME axis
    (`[..., F, D] -> [..., F, D]`, librosa.feature.delta convention):
    delta[t] = sum_{d=-W}^{W} d * x[t+d] / sum_d d^2 with edge padding.
    `order=2` applies it twice (delta-delta)."""
    if width < 3 or width % 2 == 0:
        raise ValueError("width must be an odd integer >= 3")
    if order < 1:
        raise ValueError("order must be >= 1")
    half = width // 2
    d = np.arange(-half, half + 1, dtype=np.float64)
    kernel = jnp.asarray((d / np.sum(d * d)).astype(np.float32))
    x = jnp.asarray(feat, jnp.float32)
    for _ in range(order):
        pad = jnp.pad(
            x, [(0, 0)] * (x.ndim - 2) + [(half, half), (0, 0)],
            mode="edge",
        )
        f = x.shape[-2]
        x = sum(
            kernel[k] * pad[..., k : k + f, :] for k in range(width)
        )
    return x


# ---------------------------------------------------------------------------
# linear prediction
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "order", "eps"))
def lpc(signal: jnp.ndarray, cfg: StftConfig, order: int = 16,
        eps: float = 1e-9) -> jnp.ndarray:
    """Per-frame LPC coefficients `[..., T] -> [..., F, order+1]` by the
    autocorrelation method (Levinson-Durbin), windowed with `cfg`'s window.

    Returns the all-pole polynomial A(z) = 1 + a_1 z^-1 + ... + a_p z^-p
    minimizing the forward prediction error (a[..., 0] == 1; librosa.lpc
    convention). The Levinson recursion runs as `order` vectorized steps
    over all frames at once — order is tiny, frames are the parallel axis.
    Silent frames return a[0]=1, rest 0 (eps-guarded error update)."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if order >= cfg.frame_size:
        raise ValueError(
            f"order ({order}) must be < frame_size ({cfg.frame_size})"
        )
    from .frame.framing import frame_signal
    from .window.windows import get_window

    frames = frame_signal(jnp.asarray(signal, jnp.float32), cfg.frame_spec)
    w = jnp.asarray(get_window(cfg.window, cfg.frame_size, cfg.periodic))
    frames = frames * w
    t = cfg.frame_size
    # Autocorrelation lags 0..order (order+1 shifted dot products).
    r = jnp.stack(
        [jnp.sum(frames[..., : t - k] * frames[..., k:], axis=-1)
         for k in range(order + 1)],
        axis=-1,
    )  # [..., F, order+1]

    # Levinson-Durbin, vectorized over the leading (frame) axes.
    a = [jnp.ones_like(r[..., 0])] + [jnp.zeros_like(r[..., 0])
                                      for _ in range(order)]
    err = r[..., 0]
    for i in range(1, order + 1):
        acc = r[..., i]
        for j in range(1, i):
            acc = acc + a[j] * r[..., i - j]
        k = -acc / (err + eps)
        new = [a[j] + k * a[i - j] for j in range(1, i)]
        for j in range(1, i):
            a[j] = new[j - 1]
        a[i] = k
        err = err * (1.0 - k * k)
    return jnp.stack(a, axis=-1)


@partial(jax.jit, static_argnames=("n_fft",))
def lpc_envelope_db(a: jnp.ndarray, n_fft: int) -> jnp.ndarray:
    """All-pole spectral envelope from LPC coefficients:
    `[..., order+1] -> [..., n_fft//2+1]` in dB, -20*log10|A(e^jw)|
    (gain-free shape; add the frame's error power for absolute level)."""
    a = jnp.asarray(a, jnp.float32)
    spec = jnp.fft.rfft(a, n=n_fft, axis=-1)
    mag = jnp.sqrt(jnp.square(spec.real) + jnp.square(spec.imag))
    return -20.0 * jnp.log10(jnp.maximum(mag, 1e-12))


@partial(jax.jit, static_argnames=("cfg", "eps"))
def real_cepstrum(signal: jnp.ndarray, cfg: StftConfig,
                  eps: float = 1e-10) -> jnp.ndarray:
    """Per-frame real cepstrum `[..., T] -> [..., F, frame_size]`:
    irfft(log |STFT|) — an echo at lag d puts a peak at quefrency d."""
    from .pipeline import stft

    spec = stft(jnp.asarray(signal, jnp.float32), cfg)
    logmag = 0.5 * jnp.log(
        jnp.maximum(jnp.square(spec.real) + jnp.square(spec.imag), eps * eps)
    )
    return jnp.fft.irfft(logmag.astype(jnp.complex64), n=cfg.frame_size,
                         axis=-1)


# ---------------------------------------------------------------------------
# inversion: MFCC -> mel -> linear power -> audio
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_mels", "floor_db"))
def mfcc_to_mel(coeffs: jnp.ndarray, n_mels: int = 64,
                floor_db: float = -100.0) -> jnp.ndarray:
    """Invert `mfcc`: `[..., F, n_mfcc] -> [..., F, n_mels]` mel POWER.

    The DCT-II is orthonormal, so truncation to n_mfcc coefficients makes
    this the least-squares inverse (exact when n_mfcc == n_mels); the dB
    log is inverted exactly down to its floor."""
    n_mfcc = coeffs.shape[-1]
    if n_mfcc > n_mels:
        raise ValueError(f"n_mfcc ({n_mfcc}) must be <= n_mels ({n_mels})")
    dct = _dct_ii_ortho(n_mfcc, n_mels)
    logmel = _mm(coeffs, jnp.asarray(dct))  # orthonormal => transpose inverse
    return jnp.power(10.0, jnp.clip(logmel, floor_db, None) / 10.0)


@partial(jax.jit, static_argnames=(
    "sr", "n_fft", "n_mels", "fmin", "fmax", "htk", "norm", "iters"))
def mel_to_linear(
    mel_power: jnp.ndarray,
    sr: float,
    n_fft: int,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    iters: int = 32,
) -> jnp.ndarray:
    """Approximately invert the mel filterbank:
    `[..., F, n_mels] -> [..., F, n_fft//2+1]` nonnegative linear power.

    Solves min ||fb @ s - mel||_2 with s >= 0 per frame by multiplicative
    (Lee-Seung) updates — every step is a pair of `[K, n_mels]` matmuls,
    so the whole solver is `iters` matmul passes inside one jit (the NNLS
    analog of librosa.feature.inverse.mel_to_stft)."""
    fb = jnp.asarray(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm)
    )  # [M, K]
    mel_power = jnp.maximum(jnp.asarray(mel_power), 0.0)
    eps = jnp.float32(1e-12)
    num = _mm(mel_power, fb)  # fb^T applied per frame (row convention); fixed
    s = num  # transpose-map init: nonnegative, right support

    def body(_, s):
        den = _mm(_mm(s, fb.T), fb) + eps
        return s * num / den

    return jax.lax.fori_loop(0, iters, body, s)


def mel_to_audio(
    mel_power: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_mels: int = 64,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    nnls_iters: int = 32,
    gl_iters: int = 32,
    length: Optional[int] = None,
) -> jnp.ndarray:
    """Mel power spectrogram -> waveform: NNLS filterbank inversion
    (`mel_to_linear`) then Griffin-Lim phase reconstruction. The standard
    neural-vocoder-free mel inversion path (librosa mel_to_audio analog),
    built entirely from this framework's matmul DFT + OLA."""
    from .griffinlim import griffin_lim

    p = mel_to_linear(mel_power, sr, cfg.frame_size, n_mels, fmin, fmax,
                      htk, norm, iters=nnls_iters)
    mag = jnp.sqrt(jnp.maximum(p, 0.0))
    return griffin_lim(mag, cfg, iters=gl_iters, length=length)


# ---------------------------------------------------------------------------
# analytic signal (Hilbert) utilities
# ---------------------------------------------------------------------------

def _analytic(x: jnp.ndarray) -> jnp.ndarray:
    """Analytic signal via the frequency-domain Hilbert construction
    (scipy.signal.hilbert): one-sided spectrum doubling, complex ifft.
    Callers return real reductions of it."""
    t = x.shape[-1]
    spec = jnp.fft.fft(x, axis=-1)
    h = np.zeros(t)
    h[0] = 1.0
    if t % 2 == 0:
        h[t // 2] = 1.0
        h[1 : t // 2] = 2.0
    else:
        h[1 : (t + 1) // 2] = 2.0
    return jnp.fft.ifft(spec * jnp.asarray(h), axis=-1)


@jax.jit
def envelope(signal: jnp.ndarray) -> jnp.ndarray:
    """Instantaneous amplitude |analytic(x)| of `[..., T]` (the Hilbert
    envelope; matches abs(scipy.signal.hilbert(x)))."""
    return jnp.abs(_analytic(jnp.asarray(signal, jnp.float32)))


@partial(jax.jit, static_argnames=("sr",))
def instantaneous_frequency(signal: jnp.ndarray, sr: float) -> jnp.ndarray:
    """Instantaneous frequency (Hz) of `[..., T] -> [..., T-1]`: the
    wrapped first difference of the analytic phase. Uses the conjugate-
    product formulation angle(a[t+1] * conj(a[t])) — already wrapped to
    (-pi, pi], so no explicit unwrap pass is needed."""
    a = _analytic(jnp.asarray(signal, jnp.float32))
    prod = a[..., 1:] * jnp.conj(a[..., :-1])
    dphi = jnp.arctan2(prod.imag, prod.real)
    return dphi * (sr / (2.0 * np.pi))


@partial(jax.jit, static_argnames=("cfg",))
def frame_rms(signal: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Per-frame RMS level `[..., T] -> [..., F]` over the raw (unwindowed)
    frames of `cfg`'s framing."""
    from .frame.framing import frame_signal

    frames = frame_signal(jnp.asarray(signal, jnp.float32), cfg.frame_spec)
    return jnp.sqrt(jnp.mean(jnp.square(frames), axis=-1))


@partial(jax.jit, static_argnames=("cfg",))
def zero_crossing_rate(signal: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """Per-frame zero-crossing rate `[..., T] -> [..., F]` in [0, 1]:
    fraction of adjacent sample pairs within the frame whose signs differ
    (zero counts as nonnegative)."""
    from .frame.framing import frame_signal

    frames = frame_signal(jnp.asarray(signal, jnp.float32), cfg.frame_spec)
    pos = frames >= 0
    flips = pos[..., 1:] != pos[..., :-1]
    return jnp.mean(flips.astype(jnp.float32), axis=-1)


@partial(jax.jit, static_argnames=("cfg", "eps"))
def spectral_flatness(signal: jnp.ndarray, cfg: StftConfig,
                      eps: float = 1e-10) -> jnp.ndarray:
    """Wiener entropy per frame: geometric / arithmetic mean of the power
    spectrum, in (0, 1]. ~1 for white noise, ~0 for a pure tone."""
    p = _power_spectrogram(jnp.asarray(signal), cfg) + eps
    log_gm = jnp.mean(jnp.log(p), axis=-1)
    am = jnp.mean(p, axis=-1)
    return jnp.exp(log_gm) / am


def _contrast_band_slices(
    sr: float, n_fft: int, n_bands: int, fmin: float
) -> Tuple[Tuple[int, int], ...]:
    """Octave-band bin ranges for spectral contrast: band 0 = [0, fmin),
    band b = [fmin*2^(b-1), fmin*2^b) Hz, the last band clipped at
    Nyquist. Designed on host from static args; every band must hold at
    least 2 bins so the quantile split is meaningful."""
    k = n_fft // 2 + 1
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    edges = [0.0] + [fmin * (2.0 ** b) for b in range(n_bands + 1)]
    edges[-1] = min(edges[-1], sr / 2.0)
    out = []
    for lo_hz, hi_hz in zip(edges[:-1], edges[1:]):
        lo = int(np.searchsorted(freqs, lo_hz, side="left"))
        hi = int(np.searchsorted(freqs, hi_hz, side="left"))
        hi = min(max(hi, lo + 2), k)
        if hi - lo < 2 or lo >= k - 1:
            raise ValueError(
                f"spectral_contrast band [{lo_hz:.0f}, {hi_hz:.0f}) Hz has "
                f"<2 bins at n_fft={n_fft}, sr={sr}; lower n_bands or fmin"
            )
        out.append((lo, hi))
    return tuple(out)


@partial(jax.jit, static_argnames=(
    "cfg", "sr", "n_bands", "fmin", "quantile", "linear"))
def spectral_contrast(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_bands: int = 6,
    fmin: float = 200.0,
    quantile: float = 0.02,
    linear: bool = False,
) -> jnp.ndarray:
    """Octave-band spectral contrast `[..., T] -> [..., F, n_bands+1]`:
    per frame and band, the gap between the mean of the top `quantile` of
    power bins (peak) and the mean of the bottom `quantile` (valley) — in
    dB by default, as a linear peak/valley ratio with `linear=True`.
    High for tonal/peaked spectra, near 0 dB for white noise.

    Static shapes: band bin ranges are static (host-designed octave edges),
    so each band is a static slice + `jnp.sort` along its bins — a Python
    loop over ~7 small vectorized sorts, no dynamic shapes.
    """
    if not 0.0 < quantile <= 0.5:
        raise ValueError(f"quantile must be in (0, 0.5], got {quantile}")
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    bands = _contrast_band_slices(sr, cfg.frame_size, n_bands, fmin)
    cols = []
    for lo, hi in bands:
        nb = hi - lo
        k = max(1, int(round(quantile * nb)))
        s = jnp.sort(p[..., lo:hi], axis=-1)
        valley = jnp.mean(s[..., :k], axis=-1)
        peak = jnp.mean(s[..., nb - k:], axis=-1)
        ratio = jnp.maximum(peak, 1e-20) / jnp.maximum(valley, 1e-20)
        cols.append(ratio if linear else 10.0 * jnp.log10(ratio))
    return jnp.stack(cols, axis=-1)


def _tonnetz_basis(n_chroma: int) -> np.ndarray:
    """Harte/Sandler/Gasser 2006 tonal-centroid projection `[6, n_chroma]`:
    pitch classes mapped onto three circles — fifths (radius 1), minor
    thirds (radius 1), major thirds (radius 0.5) — as (sin, cos) pairs.
    Host-designed in float64, cached by key."""
    key = ("tonnetz", n_chroma)
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    l = np.arange(n_chroma, dtype=np.float64) * (12.0 / n_chroma)
    angles = np.vstack([
        l * 7.0 * np.pi / 6.0,   # circle of fifths
        l * 3.0 * np.pi / 2.0,   # minor thirds
        l * 2.0 * np.pi / 3.0,   # major thirds
    ])
    radii = np.array([1.0, 1.0, 0.5])[:, None]
    basis = np.empty((6, n_chroma), np.float64)
    basis[0::2] = radii * np.sin(angles)
    basis[1::2] = radii * np.cos(angles)
    basis = basis.astype(np.float32)
    with _CACHE_LOCK:
        _CACHE[key] = basis
    return basis


@partial(jax.jit, static_argnames=("cfg", "sr", "n_chroma", "sigma", "fmin"))
def tonnetz(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_chroma: int = 12,
    sigma: float = 1.0,
    fmin: float = 32.0,
) -> jnp.ndarray:
    """Tonal centroid features `[..., T] -> [..., F, 6]`: the chroma
    vector (L1-normalized per frame) projected onto the fifths /
    minor-third / major-third circles. Harmonically related pitch
    classes land near each other (a fifth is 30 deg on the first circle;
    a tritone is antipodal), which is what makes these useful for chord
    and key tracking. One extra [6, 12] matmul on top of `chroma`."""
    c = chroma(signal, cfg, sr, n_chroma=n_chroma, sigma=sigma, fmin=fmin)
    c = c / jnp.maximum(jnp.sum(c, axis=-1, keepdims=True), 1e-10)
    return _mm(c, jnp.asarray(_tonnetz_basis(n_chroma)).T)


@partial(jax.jit, static_argnames=(
    "frame_rate", "time_constant", "gain", "bias", "power", "eps"))
def pcen(
    spec: jnp.ndarray,
    frame_rate: float,
    time_constant: float = 0.4,
    gain: float = 0.98,
    bias: float = 2.0,
    power: float = 0.5,
    eps: float = 1e-6,
    zi: Optional[jnp.ndarray] = None,
):
    """Per-channel energy normalization (Wang et al. 2017) of a
    nonnegative spectrogram `[..., F, K]` (frames on axis -2, e.g. a mel
    spectrogram): an automatic-gain-control divide by a one-pole temporal
    smoother, then root compression —

        M[t] = (1-s) M[t-1] + s S[t]
        PCEN = (S / (eps + M)^gain + bias)^power - bias^power

    `frame_rate` = sr / hop_size; the smoothing coefficient follows the
    librosa convention s = (sqrt(1 + 4 T^2) - 1) / (2 T^2) with
    T = time_constant * frame_rate. The smoother is the framework's
    log-depth scan IIR (iir.lfilter) applied along frames, initialized at
    M[-1] = S[0] so frame 0 is not transient-shocked. Replaces the
    dB+mean-variance normalization stage in keyword-spotting/ASR
    front-ends; loudness-invariant by construction.

    Streaming: pass `zi` = the previous chunk's final smoother state
    `[..., K]` (the second element of the returned tuple) to continue a
    stream across chunk boundaries; with `zi` given the function returns
    `(out, zf)` instead of `out` alone (the iir.lfilter convention).
    """
    from .iir import lfilter

    if time_constant <= 0 or frame_rate <= 0:
        raise ValueError("frame_rate and time_constant must be > 0")
    t = time_constant * frame_rate
    s = float((np.sqrt(1.0 + 4.0 * t * t) - 1.0) / (2.0 * t * t))
    x = jnp.maximum(jnp.asarray(spec, jnp.float32), 0.0)
    xt = jnp.swapaxes(x, -2, -1)  # [..., K, F]: smooth along last axis
    if zi is None:
        z0 = (1.0 - s) * xt[..., :1]  # DF2T state for M[-1] = S[0]
    else:
        z0 = (1.0 - s) * jnp.asarray(zi, jnp.float32)[..., None]
    m, zf = lfilter([s], [1.0, -(1.0 - s)], xt, zi=z0)
    m = jnp.swapaxes(m, -2, -1)
    agc = x / jnp.power(eps + m, gain)
    out = jnp.power(agc + bias, power) - bias ** power
    if zi is None:
        return out
    return out, m[..., -1, :]


def cqt_filterbank(
    sr: float,
    n_fft: int,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,  # C1
) -> np.ndarray:
    """Constant-Q analysis filterbank `[n_bins, n_fft//2 + 1]` (host f64,
    cached): bin b is a Gaussian centered at fmin * 2^(b/bins_per_octave)
    whose width tracks the constant-Q bandwidth f/Q with
    Q = 1 / (2^(1/bpo) - 1), floored at one FFT bin so low bins whose Q
    bandwidth falls under the FFT's resolution still integrate a full
    bin. Rows are L1-normalized (unit response to a flat spectrum).
    """
    key = ("cqt", float(sr), n_fft, n_bins, bins_per_octave, float(fmin))
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
    if hit is not None:
        return hit
    if fmin <= 0 or n_bins < 1 or bins_per_octave < 1:
        raise ValueError("fmin > 0, n_bins >= 1, bins_per_octave >= 1")
    centers = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    if centers[-1] > sr / 2.0:
        raise ValueError(
            f"top CQT bin {centers[-1]:.1f} Hz exceeds Nyquist {sr / 2:.1f}; "
            f"lower n_bins or fmin"
        )
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    df = sr / n_fft
    # FWHM = bandwidth -> sigma = bw / (2 sqrt(2 ln 2)).
    bw = np.maximum(centers / q, df)
    sigma = bw / 2.3548200450309493
    fb = np.exp(
        -0.5 * ((freqs[None, :] - centers[:, None]) / sigma[:, None]) ** 2
    )
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-12)
    fb = fb.astype(np.float32)
    with _CACHE_LOCK:
        _CACHE[key] = fb
    return fb


@partial(jax.jit, static_argnames=(
    "cfg", "sr", "n_bins", "bins_per_octave", "fmin"))
def pseudo_cqt(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    fmin: float = 32.703194,
) -> jnp.ndarray:
    """Pseudo constant-Q power spectrogram `[..., T] -> [..., F, n_bins]`:
    the STFT power spectrogram through the constant-Q filterbank matmul
    (log-frequency axis, one matmul — the standard STFT-based CQT
    approximation; frequency resolution at the low bins is bounded by the
    FFT's sr/n_fft, see `cqt_filterbank`)."""
    fb = cqt_filterbank(sr, cfg.frame_size, n_bins, bins_per_octave, fmin)
    p = _power_spectrogram(jnp.asarray(signal), cfg)
    return _mm(p, jnp.asarray(fb).T)


@partial(jax.jit, static_argnames=("cfg", "sr", "n_octaves", "fmin"))
def chroma_cqt(
    signal: jnp.ndarray,
    cfg: StftConfig,
    sr: float,
    n_octaves: int = 7,
    fmin: float = 32.703194,  # C1 -> pitch class 0 = C
) -> jnp.ndarray:
    """Chroma from the pseudo-CQT `[..., T] -> [..., F, 12]`: 12 bins per
    octave starting at `fmin`, folded across `n_octaves` octaves by
    summation — octave-invariant by construction (unlike the STFT-bin
    chroma, whose low-octave resolution is limited by bin spacing).
    Class 0 = C when `fmin` is a C."""
    c = pseudo_cqt(
        signal, cfg, sr,
        n_bins=12 * n_octaves, bins_per_octave=12, fmin=fmin,
    )
    return c.reshape(c.shape[:-1] + (n_octaves, 12)).sum(axis=-2)
