"""IIR filtering as a parallel (log-depth) scan.

An IIR filter is the one DSP primitive that looks un-parallelizable: every
output depends on the previous one. The reference toolkit sidesteps it (FIR
only); a sequential Python/`lax.scan` loop over samples would be catastrophic
on an accelerator (one step per sample, no batching). The parallel
formulation:
the direct-form-II-transposed recurrence is an *affine* map per sample,

    s[t] = A s[t-1] + c x[t]        (A constant [N, N], c [N])
    y[t] = b0 x[t] + s[t-1][0]

and affine maps compose associatively, so the whole state trajectory comes
out of one `jax.lax.associative_scan` over (matrix, vector) pairs —
O(T log T) work at log-depth instead of O(T) sequential steps. For a biquad
(N = 2) that is 8 MACs per sample per scan level, vectorized 8x128 on the
VPU.

API mirrors scipy.signal (the test oracle): `sosfilt` (cascaded biquads,
optional `zi`/`zf` streaming state in scipy's DF2T convention), `lfilter`
(arbitrary order via the companion-form state matrix), and a
`butter_sos` Butterworth designer computed in float64 numpy on the host
(repo convention: design in f64, run in f32).

Filtering is done in float32; design constants come in as float64 and are
cast. Chunked streaming with carried `zi` matches one-shot filtering to f32
tolerance (the scan's reduction order differs across chunk boundaries, so
bit-exactness is NOT guaranteed — unlike the OLA paths; documented delta).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "lfilter",
    "butter_sos",
    "a_weighting_sos",
    "c_weighting_sos",
]


# ---------------------------------------------------------------------------
# core: affine associative scan
# ---------------------------------------------------------------------------

def _affine_scan(A, c, b0, x, s0):
    """Run the DF2T recurrence via associative_scan.

    A: [N, N], c: [N], b0: scalar (all traced f32); x: [B, T]; s0: [B, N].
    Returns (y [B, T], zf [B, N]).
    """
    n = A.shape[0]
    mats = jnp.broadcast_to(A, x.shape + (n, n))  # [B, T, N, N]
    vecs = c * x[..., None]  # [B, T, N]

    # HIGHEST precision: the contraction dim is N (2 for a biquad), so a
    # reduced-precision matmul gains nothing, and its rounding compounds
    # across the log-depth scan; exact-f32 contractions keep the >=70 dB
    # scipy-parity gate.
    hi = jax.lax.Precision.HIGHEST

    def combine(e1, e2):
        m1, v1 = e1
        m2, v2 = e2
        return (
            jnp.einsum("...ij,...jk->...ik", m2, m1, precision=hi),
            jnp.einsum("...ij,...j->...i", m2, v1, precision=hi) + v2,
        )

    m_cum, v_cum = jax.lax.associative_scan(combine, (mats, vecs), axis=1)
    # s[t] = A^(t+1)-ish cumulative map applied to the initial state.
    s = jnp.einsum("btij,bj->bti", m_cum, s0, precision=hi) + v_cum
    s_prev = jnp.concatenate([s0[:, None, :], s[:, :-1, :]], axis=1)
    y = b0 * x + s_prev[..., 0]
    return y, s[:, -1, :]


def _df2t_constants(b, a):
    """DF2T state matrix/vector from normalized (a[0]=1) coefficients.

    z_i[t] = b[i+1] x[t] - a[i+1] y[t] + z_{i+1}[t-1],  y = b[0] x + z_1[t-1]
    => A[i, 0] = -a[i+1], A[i, i+1] = 1; c[i] = b[i+1] - a[i+1] b[0].
    """
    n = a.shape[0] - 1
    A = jnp.zeros((n, n), jnp.float32)
    A = A.at[:, 0].set(-a[1:])
    if n > 1:
        A = A.at[jnp.arange(n - 1), jnp.arange(1, n)].set(1.0)
    c = b[1:] - a[1:] * b[0]
    return A, c, b[0]


def _flatten_batch(x):
    x = jnp.asarray(x, jnp.float32)
    batch_shape = x.shape[:-1]
    return x.reshape((-1, x.shape[-1])), batch_shape


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@jax.jit
def _sosfilt_impl(sos, x2, zi2):
    # x2: [B, T]; zi2: [S, B, 2]
    y = x2
    zf = []
    for s in range(sos.shape[0]):
        b = sos[s, :3] / sos[s, 3]
        a = sos[s, 3:] / sos[s, 3]
        A, c, b0 = _df2t_constants(b, a)
        y, z_last = _affine_scan(A, c, b0, y, zi2[s])
        zf.append(z_last)
    return y, jnp.stack(zf, axis=0)


def sosfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    zi: Optional[jnp.ndarray] = None,
) -> Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Cascaded-biquad IIR filter of `[..., T]` along the last axis.

    `sos` is `[n_sections, 6]` (b0 b1 b2 a0 a1 a2, scipy layout; a0 need not
    be 1). With `zi` (shape `[n_sections, ..., 2]`, scipy's DF2T state
    convention — `scipy.signal.sosfilt` parity) returns `(y, zf)` for
    chunked streaming; without it, zero initial state and returns `y` alone.
    """
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    if np.any(sos[:, 3] == 0.0):
        raise ValueError("sos a0 coefficients must be nonzero")
    x2, batch_shape = _flatten_batch(x)
    n_sections = sos.shape[0]
    want_zf = zi is not None
    if zi is None:
        zi2 = jnp.zeros((n_sections, x2.shape[0], 2), jnp.float32)
    else:
        zi = jnp.asarray(zi, jnp.float32)
        expect = (n_sections,) + batch_shape + (2,)
        if zi.shape != expect:
            raise ValueError(f"zi shape {zi.shape} != expected {expect}")
        zi2 = zi.reshape((n_sections, x2.shape[0], 2))
    y, zf = _sosfilt_impl(jnp.asarray(sos, jnp.float32), x2, zi2)
    y = y.reshape(batch_shape + y.shape[-1:])
    if want_zf:
        return y, zf.reshape((n_sections,) + batch_shape + (2,))
    return y


@jax.jit
def _lfilter_impl(b, a, x2, zi2):
    A, c, b0 = _df2t_constants(b, a)
    return _affine_scan(A, c, b0, x2, zi2)


def lfilter(
    b: np.ndarray,
    a: np.ndarray,
    x: jnp.ndarray,
    zi: Optional[jnp.ndarray] = None,
) -> Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
    """Direct-form IIR filter `[..., T]` (scipy.signal.lfilter parity,
    DF2T state convention for `zi` of shape `[..., max(len(a),len(b))-1]`).
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.ndim != 1 or b.ndim != 1 or a.size == 0 or a[0] == 0.0:
        raise ValueError("a and b must be 1-D with a[0] != 0")
    n = max(len(a), len(b)) - 1
    if n == 0:
        y = jnp.asarray(x, jnp.float32) * jnp.float32(b[0] / a[0])
        return (y, jnp.zeros(x.shape[:-1] + (0,), jnp.float32)) \
            if zi is not None else y
    bp = np.zeros(n + 1)
    bp[: len(b)] = b / a[0]
    ap = np.zeros(n + 1)
    ap[: len(a)] = a / a[0]
    x2, batch_shape = _flatten_batch(x)
    want_zf = zi is not None
    if zi is None:
        zi2 = jnp.zeros((x2.shape[0], n), jnp.float32)
    else:
        zi = jnp.asarray(zi, jnp.float32)
        expect = batch_shape + (n,)
        if zi.shape != expect:
            raise ValueError(f"zi shape {zi.shape} != expected {expect}")
        zi2 = zi.reshape((x2.shape[0], n))
    y, zf = _lfilter_impl(
        jnp.asarray(bp, jnp.float32), jnp.asarray(ap, jnp.float32), x2, zi2
    )
    y = y.reshape(batch_shape + y.shape[-1:])
    if want_zf:
        return y, zf.reshape(batch_shape + (n,))
    return y


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state DF2T state for a unit-step input, `[n_sections, 2]`
    float64 (scipy.signal.sosfilt_zi parity). Multiply by the signal's
    first sample to start a filter without a step transient — the
    initial-condition trick `sosfiltfilt` relies on. Host-side f64."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    zi = np.zeros((sos.shape[0], 2))
    scale = 1.0
    for k in range(sos.shape[0]):
        b = sos[k, :3] / sos[k, 3]
        a = sos[k, 3:] / sos[k, 3]
        # Steady state of s = A s + c for unit input (DF2T constants as in
        # _df2t_constants): solve (I - A) zi = c.
        A = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        c = b[1:] - a[1:] * b[0]
        zi[k] = scale * np.linalg.solve(np.eye(2) - A, c)
        scale *= b.sum() / a.sum()  # section DC gain feeds the next stage
    return zi


def sosfiltfilt(
    sos: np.ndarray, x: jnp.ndarray, padlen: Optional[int] = None
) -> jnp.ndarray:
    """Zero-phase forward-backward filtering (scipy.signal.sosfiltfilt
    parity: odd-extension edge padding + steady-state initial conditions).
    The effective magnitude response is squared; phase is exactly zero."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    n_sections = sos.shape[0]
    if padlen is None:
        ntaps = 2 * n_sections + 1
        ntaps -= min(
            int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum())
        )
        padlen = 3 * ntaps
    x = jnp.asarray(x, jnp.float32)
    t = x.shape[-1]
    if padlen >= t:
        raise ValueError(
            f"padlen ({padlen}) must be < signal length ({t})"
        )
    batch_shape = x.shape[:-1]
    zi_base = jnp.asarray(sosfilt_zi(sos), jnp.float32)  # [S, 2]
    zi_b = jnp.broadcast_to(
        zi_base[(slice(None),) + (None,) * len(batch_shape)],
        (n_sections,) + batch_shape + (2,),
    )

    if padlen > 0:  # odd extension about both endpoints
        left = 2.0 * x[..., :1] - x[..., padlen:0:-1]
        right = 2.0 * x[..., -1:] - x[..., -2: -padlen - 2: -1]
        ext = jnp.concatenate([left, x, right], axis=-1)
    else:
        ext = x
    def scaled_zi(first):  # first: [batch] -> [S, *batch, 1] broadcast
        return zi_b * first[None, ..., None]

    y, _ = sosfilt(sos, ext, zi=scaled_zi(ext[..., 0]))
    y = y[..., ::-1]
    y, _ = sosfilt(sos, y, zi=scaled_zi(y[..., 0]))
    y = y[..., ::-1]
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y


# ---------------------------------------------------------------------------
# shared zpk -> digital SOS machinery (host, float64 numpy)
# ---------------------------------------------------------------------------

def _bilinear_zpk_to_sos(z, p, k, fs):
    """Analog zpk -> digital `[n_sections, 6]` SOS via the bilinear
    transform s -> 2*fs*(z-1)/(z+1), then conjugate-adjacent pairing.

    Pairing keeps conjugate pairs adjacent (sorted by |imag| descending,
    real roots last); exact for the designs here (identical zeros, or all
    roots real) — this is not scipy's general nearest-pole-zero pairing.
    """
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    c2 = 2.0 * fs  # the transform constant is 2*fs, NOT fs itself
    k = k * np.real(np.prod(c2 - z) / np.prod(c2 - p))
    z_d = (c2 + z) / (c2 - z)
    p_d = (c2 + p) / (c2 - p)
    z_d = np.concatenate([z_d, -np.ones(len(p) - len(z))])

    def key(q):
        return (abs(q.imag) < 1e-12, -abs(q.imag), q.real)

    p_sorted = sorted(p_d, key=key)
    z_sorted = sorted(z_d, key=key)
    n = len(p_sorted)
    sections = []
    i = 0
    while i < n:
        # Two at a time is always safe: the sort puts conjugate pairs
        # adjacent (shared |imag| and real part) and real roots last, so a
        # window of two is either a conjugate pair or two reals — both
        # yield real biquad coefficients. A final odd leftover (odd-order
        # designs) becomes a first-order section.
        take = 2 if i + 1 < n else 1
        pp = np.array(p_sorted[i : i + take])
        zz = np.array(z_sorted[i : i + take])
        i += take
        bq = np.real(np.poly(zz))
        aq = np.real(np.poly(pp))
        if len(pp) == 1:  # first-order section, pad to biquad layout
            bq = np.append(bq, 0.0)
            aq = np.append(aq, 0.0)
        sections.append(np.concatenate([bq, aq]))
    sos = np.array(sections, dtype=np.float64)
    sos[0, :3] *= k  # overall gain into the first section's numerator
    return sos


def _sos_gain_at(sos: np.ndarray, freq: float, fs: float) -> float:
    """|H(e^{j 2 pi freq/fs})| of a digital SOS cascade (host f64)."""
    zinv = np.exp(-2j * np.pi * freq / fs)
    h = 1.0 + 0.0j
    for s in np.asarray(sos, dtype=np.float64):
        num = s[0] + s[1] * zinv + s[2] * zinv * zinv
        den = s[3] + s[4] * zinv + s[5] * zinv * zinv
        h *= num / den
    return float(np.abs(h))


# ---------------------------------------------------------------------------
# Butterworth designer (scipy.signal.butter parity)
# ---------------------------------------------------------------------------

def butter_sos(
    order: int,
    wn: float,
    btype: str = "lowpass",
    fs: Optional[float] = None,
) -> np.ndarray:
    """Butterworth digital filter as `[n_sections, 6]` SOS (float64).

    `wn` is the -3 dB frequency — normalized to Nyquist (0 < wn < 1) when
    `fs` is None, in Hz otherwise. `btype` in {"lowpass", "highpass"}.
    Designed entirely in float64 via the bilinear transform (analog
    prototype poles exp(j*pi*(2k+n+1)/(2n)), conjugate-paired into
    biquads); frequency response matches scipy.signal.butter(output="sos")
    to f64 rounding.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if fs is not None:
        wn = 2.0 * wn / fs
    if not (0.0 < wn < 1.0):
        raise ValueError(f"normalized wn must be in (0, 1), got {wn}")
    if btype not in ("lowpass", "highpass"):
        raise ValueError(f"btype must be lowpass or highpass, got {btype!r}")

    # Analog lowpass prototype (unit cutoff): left-half-plane unit poles.
    k_idx = np.arange(order)
    p = np.exp(1j * np.pi * (2.0 * k_idx + order + 1.0) / (2.0 * order))
    z = np.zeros(0, dtype=complex)
    k = 1.0

    fs2 = 2.0
    warped = 2.0 * fs2 * np.tan(np.pi * wn / fs2)
    if btype == "lowpass":
        p = p * warped
        k *= warped ** order
    else:  # highpass: lp2hp on the zpk
        # lp2hp gain: k * real(prod(-z)/prod(-p)); the prototype has no
        # zeros so the numerator's empty product is 1.
        k *= np.real(1.0 / np.prod(-p))
        p = warped / p
        z = np.zeros(order, dtype=complex)

    return _bilinear_zpk_to_sos(z, p, k, fs2)


# ---------------------------------------------------------------------------
# IEC 61672 loudness-weighting designers
# ---------------------------------------------------------------------------

# Analog corner frequencies (Hz) shared by the A and C curves.
_W1 = 2.0 * np.pi * 20.598997
_W2 = 2.0 * np.pi * 107.65265
_W3 = 2.0 * np.pi * 737.86223
_W4 = 2.0 * np.pi * 12194.217


def a_weighting_sos(fs: float) -> np.ndarray:
    """IEC 61672 A-weighting filter as digital `[3, 6]` SOS (float64).

    Analog prototype: H(s) = k s^4 / ((s+w1)^2 (s+w2) (s+w3) (s+w4)^2),
    bilinear-transformed at `fs` and renormalized to exactly 0 dB at
    1 kHz digitally (so the 1 kHz reference holds despite frequency
    warping). Accuracy vs the analog curve degrades above ~fs/6 as any
    bilinear design does; use fs >= 44.1 kHz for class-1-like accuracy.
    """
    if fs <= 2000.0:
        raise ValueError(f"fs must be > 2000 Hz for a 1 kHz reference, "
                         f"got {fs}")
    z = np.zeros(4, dtype=complex)
    p = np.array([-_W1, -_W1, -_W2, -_W3, -_W4, -_W4], dtype=complex)
    sos = _bilinear_zpk_to_sos(z, p, 1.0, fs)
    sos[0, :3] /= _sos_gain_at(sos, 1000.0, fs)
    return sos


def c_weighting_sos(fs: float) -> np.ndarray:
    """IEC 61672 C-weighting filter as digital `[2, 6]` SOS (float64):
    H(s) = k s^2 / ((s+w1)^2 (s+w4)^2), 0 dB at 1 kHz digitally."""
    if fs <= 2000.0:
        raise ValueError(f"fs must be > 2000 Hz for a 1 kHz reference, "
                         f"got {fs}")
    z = np.zeros(2, dtype=complex)
    p = np.array([-_W1, -_W1, -_W4, -_W4], dtype=complex)
    sos = _bilinear_zpk_to_sos(z, p, 1.0, fs)
    sos[0, :3] /= _sos_gain_at(sos, 1000.0, fs)
    return sos
