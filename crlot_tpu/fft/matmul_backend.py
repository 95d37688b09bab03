"""DFT-as-matmul backend: rFFT/irFFT as dense matrix products.

The O(N^2) real DFT as a single [batch, N] x [N, 2K] matmul, its
symmetry-folded half-size forms, and the blocked hop-block Toeplitz round
trip that folds the whole frame -> DFT -> response -> iDFT -> OLA chain into
one kernel (`roundtrip_composed_blocked`). `fft.dispatch` decides where
each runs; on a GPU, AUTO takes only the blocked round trip.

Numerics: basis matrices are built in float64 and cast to float32; matmuls
run at the caller's dot algorithm (true f32 by default). Round-trip RMSE is
checked by tests against the XLA backend within the reference's 1e-5 hard
gate (tests/fft_test.cc:76-82 tiering).

Memory: the basis is [N, N+2] f32 per direction (~4 MB at N=1024, ~1 GB at
N=16384) — this backend is used for N <= MAX_MATMUL_NFFT, XLA FFT otherwise
(see fft.dispatch).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

MAX_MATMUL_NFFT = 4096

# Dot algorithm when callers pass precision=None: true f32 (the HIGHEST
# tier of fft.dispatch.to_lax_precision). Pipelines pass their config's
# tier explicitly.
PRECISION = jax.lax.DotAlgorithmPreset.F32_F32_F32


def _prec(precision):
    return PRECISION if precision is None else precision


def _dot(lhs: jnp.ndarray, rhs, precision=None) -> jnp.ndarray:
    """lhs [..., K] @ rhs [K, M] at `precision`. A product with one lhs row
    takes F32_F32_F32 in place of BF16_BF16_F32_X3: the GPU runs that
    matrix-vector product as a single bf16 pass (error 4.5e-3 against
    1.6e-5 with two rows or more, measured on an H100)."""
    prec = _prec(precision)
    if (prec == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
            and lhs.size == lhs.shape[-1]):
        prec = jax.lax.DotAlgorithmPreset.F32_F32_F32
    return jnp.dot(lhs, rhs, precision=prec)


@lru_cache(maxsize=None)
def _forward_basis(nfft: int) -> np.ndarray:
    """[N, 2K] with columns [cos | -sin]: x @ B -> [Re(X) | Im(X)]."""
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    n = np.arange(nfft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@lru_cache(maxsize=None)
def _inverse_basis(nfft: int) -> np.ndarray:
    """[2K, N]: [Re(X) | Im(X)] @ B -> x, with hermitian weights and 1/N."""
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    n = np.arange(nfft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / nfft
    w = np.full(kk, 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    cos_part = (w[:, None] * np.cos(ang)) / nfft
    sin_part = -(w[:, None] * np.sin(ang)) / nfft
    return np.concatenate([cos_part, sin_part], axis=0).astype(np.float32)


def rfft_matmul(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Real [..., nfft] -> complex64 [..., nfft//2+1] via one matmul."""
    basis = jnp.asarray(_forward_basis(nfft))
    flat = _dot(x.astype(jnp.float32), basis, precision)
    kk = nfft // 2 + 1
    return jax.lax.complex(flat[..., :kk], flat[..., kk:])


def irfft_matmul(spec: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Complex [..., nfft//2+1] -> real [..., nfft] (includes 1/N)."""
    basis = jnp.asarray(_inverse_basis(nfft))
    ri = jnp.concatenate([spec.real, spec.imag], axis=-1).astype(jnp.float32)
    return _dot(ri, basis, precision)


@lru_cache(maxsize=None)
def _windowed_forward_basis(nfft: int, window_bytes: bytes) -> np.ndarray:
    """Forward basis with the analysis window folded in:
    (x * w) @ B == x @ (diag(w) @ B). Saves a full elementwise pass over the
    frame matrix — the window costs zero on the matmul path."""
    w = np.frombuffer(window_bytes, dtype=np.float64)
    assert len(w) == nfft
    return (w[:, None] * _forward_basis(nfft).astype(np.float64)).astype(
        np.float32
    )


def rfft_windowed_matmul(
    x: jnp.ndarray, nfft: int, window_f64: np.ndarray, precision=None
) -> jnp.ndarray:
    """rfft(x * window) as ONE matmul on unwindowed frames."""
    basis = jnp.asarray(
        _windowed_forward_basis(nfft, np.asarray(window_f64, np.float64).tobytes())
    )
    flat = _dot(x.astype(jnp.float32), basis, precision)
    kk = nfft // 2 + 1
    return jax.lax.complex(flat[..., :kk], flat[..., kk:])


@lru_cache(maxsize=None)
def _windowed_inverse_basis(nfft: int, window_bytes: bytes) -> np.ndarray:
    """Inverse basis with a synthesis window folded in (columns scaled)."""
    w = np.frombuffer(window_bytes, dtype=np.float64)
    assert len(w) == nfft
    base = _inverse_basis(nfft).astype(np.float64)
    return (base * w[None, :]).astype(np.float32)


@lru_cache(maxsize=None)
def _folded_forward_consts(nfft: int):
    """Half-size forward bases exploiting DFT-row symmetry.

    The direct basis B (cols [cos | -sin]) satisfies B[N-n, :K] = B[n, :K]
    and B[N-n, K:] = -B[n, K:], so folding the frame into even/odd parts
    halves the matmul contraction dim — and therefore the DFT FLOPs —
    exactly, with identical f64-designed numerics.

    Returns C [N/2+1, K] (cos rows for n = 0..N/2; row 0 is all-ones, row
    N/2 is (-1)^k) and S [N/2-1, K] (-sin rows for n = 1..N/2-1).
    """
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    n_e = np.arange(nfft // 2 + 1, dtype=np.float64)
    n_o = np.arange(1, nfft // 2, dtype=np.float64)
    c = np.cos(2.0 * np.pi * np.outer(n_e, k) / nfft)
    s = -np.sin(2.0 * np.pi * np.outer(n_o, k) / nfft)
    return c.astype(np.float32), s.astype(np.float32)


@lru_cache(maxsize=None)
def _folded_inverse_consts(nfft: int):
    """Half-size inverse bases (hermitian weights and 1/N included).

    A = Re(X) @ Cinv gives x[0], (x[n]+x[N-n])/2 for n = 1..N/2-1, x[N/2];
    B = Im(X) @ Sinv gives (x[n]-x[N-n])/2 for n = 1..N/2-1.
    """
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    w = np.full(kk, 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    n_e = np.arange(nfft // 2 + 1, dtype=np.float64)
    n_o = np.arange(1, nfft // 2, dtype=np.float64)
    cinv = (w[:, None] * np.cos(2.0 * np.pi * np.outer(k, n_e) / nfft)) / nfft
    sinv = -(w[:, None] * np.sin(2.0 * np.pi * np.outer(k, n_o) / nfft)) / nfft
    return cinv.astype(np.float32), sinv.astype(np.float32)


def _fold_frames(y: jnp.ndarray, nfft: int):
    """[..., N] -> even part [..., N/2+1], odd part [..., N/2-1]."""
    h = nfft // 2
    head = y[..., 1:h]
    tail = jnp.flip(y[..., h + 1 :], axis=-1)
    even = jnp.concatenate(
        [y[..., :1], head + tail, y[..., h : h + 1]], axis=-1
    )
    odd = head - tail
    return even, odd


def rfft_folded_packed(
    x: jnp.ndarray, nfft: int, window_f32=None, precision=None
):
    """rfft(x [* window]) -> (Re [..., K], Im [..., K]) via two half-size
    matmuls (half the FLOPs of the direct [N, 2K] basis)."""
    cb, sb = _folded_forward_consts(nfft)
    y = x.astype(jnp.float32)
    if window_f32 is not None:
        y = y * window_f32
    even, odd = _fold_frames(y, nfft)
    re = _dot(even, jnp.asarray(cb), precision)
    if sb.shape[0]:
        im = _dot(odd, jnp.asarray(sb), precision)
    else:
        im = jnp.zeros(re.shape, re.dtype)
    return re, im


def irfft_folded_parts(
    re: jnp.ndarray, im: jnp.ndarray, nfft: int, precision=None
) -> jnp.ndarray:
    """(Re, Im) [..., K] -> real [..., N] (includes 1/N) via two half-size
    matmuls plus an elementwise unfold."""
    cinv, sinv = _folded_inverse_consts(nfft)
    a = _dot(re.astype(jnp.float32), jnp.asarray(cinv), precision)
    h = nfft // 2
    if sinv.shape[1]:
        b = _dot(im.astype(jnp.float32), jnp.asarray(sinv), precision)
        mid = a[..., 1:h]
        return jnp.concatenate(
            [
                a[..., :1],
                mid + b,
                a[..., h : h + 1],
                jnp.flip(mid - b, axis=-1),
            ],
            axis=-1,
        )
    return a  # nfft == 2: output is [x0, x1] = [A0, A1]


@lru_cache(maxsize=None)
def _tiled_consts(nfft: int):
    """Power-of-two cores of the folded bases + their rank-1 borders.

    The folded bases are [h+1, h+1] (h = nfft//2); an (h+1)-sized matmul
    dim pads to the next tile multiple. The h-th row/column of
    each basis is an EXACT alternating-sign vector (cos(pi*n) = (-1)^n), so
    every matmul splits into a clean [h, h] core plus a rank-1 border
    handled as one fused elementwise outer-product/reduction:

      Re[:, :h] = e[:, :h] @ C[:h, :h] + e[:, h] (x) (-1)^k
      Re[:, h]  = sum_n e[:, n] (-1)^n + e[:, h] (-1)^h        (matvec)
      Im        = o @ S[:, 1:h]   (Im[0] = Im[h] = 0 exactly — sin(0),
                                   sin(pi n); contraction h-1 is already
                                   one pad short of aligned)
      a[:, :h]  = Re[:, :h] @ Cinv[:h, :h] + Re[:, h] (x) (-1)^n / N
      a[:, h]   = sum_k Re[:, k] w_k (-1)^k / N + Re[:, h] (-1)^h / N
      b         = Im_eff @ Sinv[1:h, :]                        (clean)
    """
    h = nfft // 2
    c, s = _folded_forward_consts(nfft)  # [h+1, h+1], [h-1, h+1]
    cinv, sinv = _folded_inverse_consts(nfft)  # [h+1, h+1], [h+1, h-1]
    c512 = np.ascontiguousarray(c[:h, :h])
    s_eff = np.ascontiguousarray(s[:, 1:h])  # [h-1, h-1]
    ci512 = np.ascontiguousarray(cinv[:h, :h])
    si_eff = np.ascontiguousarray(sinv[1:h, :])  # [h-1, h-1]
    cvec = np.ascontiguousarray(cinv[:h, h])  # w_k (-1)^k / N, k = 0..h-1
    alt = np.where(np.arange(h) % 2 == 0, 1.0, -1.0).astype(np.float32)
    sign_h = 1.0 if h % 2 == 0 else -1.0
    return c512, s_eff, ci512, si_eff, cvec, alt, sign_h


def tiled_supported(nfft: int) -> bool:
    return nfft % 256 == 0 and nfft <= MAX_MATMUL_NFFT


@lru_cache(maxsize=None)
def _tiled_inverse_gained(nfft: int, gains_bytes: bytes):
    """Tiled inverse consts with a REAL per-bin gain g[K] folded in (f64,
    exact): a = (Re * g) @ Cinv == Re @ (diag(g) @ Cinv), so a fixed
    spectral EQ costs exactly zero — the constants absorb it.

    Returns (ci512_g, si_eff_g, cvec_g, g_nyq) mirroring _tiled_consts'
    inverse pieces with rows k scaled by g[k]."""
    g = np.frombuffer(gains_bytes, dtype=np.float64)
    h = nfft // 2
    assert len(g) == h + 1
    cinv, sinv = _folded_inverse_consts(nfft)
    ci512_g = np.ascontiguousarray(
        (cinv[:h, :h].astype(np.float64) * g[:h, None]).astype(np.float32)
    )
    si_eff_g = np.ascontiguousarray(
        (sinv[1:h, :].astype(np.float64) * g[1:h, None]).astype(np.float32)
    )
    cvec_g = np.ascontiguousarray(
        (cinv[:h, h].astype(np.float64) * g[:h]).astype(np.float32)
    )
    return ci512_g, si_eff_g, cvec_g, float(g[h])


def rfft_folded_tiled_parts(
    x: jnp.ndarray, nfft: int, window_f32=None, precision=None
):
    """rfft(x [* w]) -> (re512 [..., h], re_nyq [..., 1], im_eff [..., h-1])
    — the packed-real spectrum in its tiled layout (bins
    k = 0..h-1, the Nyquist bin, and Im k = 1..h-1; Im[0] = Im[h] = 0)."""
    c512, s_eff, _, _, _, alt, sign_h = _tiled_consts(nfft)
    h = nfft // 2
    y = x.astype(jnp.float32)
    if window_f32 is not None:
        y = y * window_f32
    head = y[..., 1:h]
    tail = jnp.flip(y[..., h + 1 :], axis=-1)
    e512 = jnp.concatenate([y[..., :1], head + tail], axis=-1)  # n = 0..h-1
    e_n = y[..., h : h + 1]
    o = head - tail
    altj = jnp.asarray(alt)
    re512 = (
        _dot(e512, jnp.asarray(c512), precision)
        + e_n * altj
    )
    re_nyq = jnp.sum(e512 * altj, axis=-1, keepdims=True) + e_n * sign_h
    im_eff = _dot(o, jnp.asarray(s_eff), precision)
    return re512, re_nyq, im_eff


def irfft_folded_tiled_parts(
    re512: jnp.ndarray,
    re_nyq: jnp.ndarray,
    im_eff: jnp.ndarray,
    nfft: int,
    precision=None,
    per_bin_gains_f64=None,
) -> jnp.ndarray:
    """Tiled-layout packed spectrum -> real [..., nfft] (includes 1/N).

    `per_bin_gains_f64` (optional f64 [K]) applies a REAL per-bin spectral
    gain at zero runtime cost by scaling the inverse constants."""
    _, _, ci512, si_eff, cvec, alt, sign_h = _tiled_consts(nfft)
    g_nyq = 1.0
    if per_bin_gains_f64 is not None:
        ci512, si_eff, cvec, g_nyq = _tiled_inverse_gained(
            nfft, np.ascontiguousarray(per_bin_gains_f64, np.float64).tobytes()
        )
    h = nfft // 2
    altj = jnp.asarray(alt)
    a512 = (
        _dot(re512, jnp.asarray(ci512), precision)
        + (re_nyq * g_nyq) * (altj / nfft)
    )
    a_nyq = (
        jnp.sum(re512 * jnp.asarray(cvec), axis=-1, keepdims=True)
        + re_nyq * (g_nyq * sign_h / nfft)
    )
    b = _dot(im_eff, jnp.asarray(si_eff), precision)
    mid = a512[..., 1:h]
    return jnp.concatenate(
        [a512[..., :1], mid + b, a_nyq, jnp.flip(mid - b, axis=-1)],
        axis=-1,
    )


def roundtrip_folded_tiled(
    frames: jnp.ndarray,
    nfft: int,
    analysis_window_f64: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
    per_bin_gains_f64=None,
) -> jnp.ndarray:
    """irfft(rfft(frames * w) [* g]) with every matmul dim a multiple of
    128: the four folded half-bases shed their (h+1)-th row/column into
    exact alternating-sign rank-1 corrections (see _tiled_consts), so
    every matmul dim is a power of two, with identical-tier numerics.
    A real per-bin spectral gain g[K] folds into the inverse constants
    (per_bin_gains_f64) — fixed spectral EQ runs at identity cost."""
    w = jnp.asarray(np.asarray(analysis_window_f64, np.float32))
    re512, re_nyq, im_eff = rfft_folded_tiled_parts(frames, nfft, w, precision)
    out = irfft_folded_tiled_parts(
        re512, re_nyq, im_eff, nfft, precision, per_bin_gains_f64
    )
    if synthesis_window_f64 is not None:
        out = out * jnp.asarray(np.asarray(synthesis_window_f64, np.float32))
    return out


def tiled_parts_to_packed(re512, re_nyq, im_eff):
    """Tiled-layout spectrum -> full packed planes (Re [..., K], Im [..., K])
    with the structurally-zero Im[0] / Im[Nyquist] filled in. Used to hand a
    `.packed(re, im)` spectral fn the spectrum without complex interleave."""
    re = jnp.concatenate([re512, re_nyq], axis=-1)
    zero = jnp.zeros_like(re_nyq)
    im = jnp.concatenate([zero, im_eff, zero], axis=-1)
    return re, im


def packed_to_tiled_parts(re, im, nfft: int):
    """Inverse of tiled_parts_to_packed (drops Im[0] / Im[Nyquist], which the
    tiled inverse ignores — the same projection irfft applies)."""
    h = nfft // 2
    return re[..., :h], re[..., h : h + 1], im[..., 1:h]


def _tiled_to_complex(re512, re_nyq, im_eff) -> jnp.ndarray:
    re = jnp.concatenate([re512, re_nyq], axis=-1)
    zero = jnp.zeros_like(re_nyq)
    im = jnp.concatenate([zero, im_eff, zero], axis=-1)
    return jax.lax.complex(re, im)


def rfft_tiled(
    x: jnp.ndarray, nfft: int, window_f64=None, precision=None
) -> jnp.ndarray:
    """Real [..., nfft] -> complex64 [..., K] via the tiled
    cores (requires tiled_supported(nfft)); window optional (f64 design)."""
    w = (
        None
        if window_f64 is None
        else jnp.asarray(np.asarray(window_f64, np.float32))
    )
    return _tiled_to_complex(*rfft_folded_tiled_parts(x, nfft, w, precision))


def irfft_tiled(spec: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Complex [..., K] -> real [..., nfft] via the tiled cores. The Im[0]
    and Im[Nyquist] inputs are ignored (exactly zero for any spectrum that
    came from real input; callers with synthetic spectra get the same
    projection the reference irfft applies)."""
    h = nfft // 2
    return irfft_folded_tiled_parts(
        spec.real[..., :h],
        spec.real[..., h : h + 1],
        spec.imag[..., 1:h],
        nfft,
        precision,
    )


def rfft_folded(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Real [..., nfft] -> complex64 [..., K] via the folded half-bases."""
    if tiled_supported(nfft):
        return rfft_tiled(x, nfft, None, precision)
    re, im = rfft_folded_packed(x, nfft, None, precision)
    return jax.lax.complex(re, im)


def irfft_folded(spec: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Complex [..., K] -> real [..., nfft] via the folded half-bases."""
    if tiled_supported(nfft):
        return irfft_tiled(spec, nfft, precision)
    return irfft_folded_parts(spec.real, spec.imag, nfft, precision)


def rfft_windowed_folded(
    x: jnp.ndarray, nfft: int, window_f64: np.ndarray, precision=None
) -> jnp.ndarray:
    """rfft(x * window) -> complex64 via the folded half-bases."""
    if tiled_supported(nfft):
        return rfft_tiled(x, nfft, window_f64, precision)
    w = jnp.asarray(np.asarray(window_f64, np.float32))
    re, im = rfft_folded_packed(x, nfft, w, precision)
    return jax.lax.complex(re, im)


def roundtrip_folded_matmul(
    frames: jnp.ndarray,
    nfft: int,
    analysis_window_f64: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
) -> jnp.ndarray:
    """irfft(rfft(frames * w)) with all four matmuls at half contraction
    size and no complex dtype: Re/Im stay as separate packed-real arrays
    between the forward and inverse half-bases. Exactly half the FLOPs
    of roundtrip_packed_matmul."""
    w = jnp.asarray(np.asarray(analysis_window_f64, np.float32))
    re, im = rfft_folded_packed(frames, nfft, w, precision)
    out = irfft_folded_parts(re, im, nfft, precision)
    if synthesis_window_f64 is not None:
        out = out * jnp.asarray(np.asarray(synthesis_window_f64, np.float32))
    return out


@lru_cache(maxsize=None)
def _composed_roundtrip_basis(
    nfft: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
) -> np.ndarray:
    """[N, N] M = diag(w_a) . Re(B_f . diag(g) . B_i) [. diag(w_s)], f64.

    The whole frame -> spectrum -> per-bin response -> frame round-trip
    is a LINEAR map per frame, so for a FIXED response curve g [K]
    (real gains OR complex — any per-frame LTI filter: EQ, FIR response,
    fractional delay, allpass) it composes into one matrix on the host
    (exactly, in f64) and runs as ONE matmul: the same N^2 MAC count
    as the four folded half-matmuls (4 x (N/2)^2), but zero spectrum
    intermediates in HBM, no fold/unfold elementwise passes, and a
    single launch. Since irfft(rfft(y) * g) is CIRCULAR convolution with
    h = irfft(g), the matrix is the windowed circulant
    M[i, j] = w[i] * h[(j - i) mod N] — built by indexing, not a host
    matmul (8.3 s -> 0.26 s at N=4096, identical to 6e-11); irfft's
    DC/Nyquist-imag projection rides along for free. Only the identity
    case must NOT use this (g = 1 collapses M to diag(w) — that would
    skip the DFT machinery the round-trip exists to run)."""
    kk = nfft // 2 + 1
    w = np.frombuffer(awin_bytes, dtype=np.float64)
    g = np.frombuffer(response_bytes, dtype=np.complex128)
    assert len(w) == nfft and len(g) == kk
    h = np.fft.irfft(g, n=nfft)
    idx = (np.arange(nfft)[None, :] - np.arange(nfft)[:, None]) % nfft
    m = w[:, None] * h[idx]
    if swin_bytes is not None:
        ws = np.frombuffer(swin_bytes, dtype=np.float64)
        m = m * ws[None, :]
    return m.astype(np.float32)


def roundtrip_composed_matmul(
    frames: jnp.ndarray,
    nfft: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
) -> jnp.ndarray:
    """irfft(rfft(frames * w) * g) [* w_s] as ONE [F, N] @ [N, N] matmul
    (see _composed_roundtrip_basis). g may be real gains or a complex
    frequency response (hermitian extension implied, like irfft)."""
    m = jnp.asarray(
        _composed_roundtrip_basis(
            nfft,
            np.ascontiguousarray(analysis_window_f64, np.float64).tobytes(),
            None
            if synthesis_window_f64 is None
            else np.ascontiguousarray(
                synthesis_window_f64, np.float64
            ).tobytes(),
            np.ascontiguousarray(per_bin_response, np.complex128).tobytes(),
        )
    )
    return _dot(frames.astype(jnp.float32), m, precision)


@lru_cache(maxsize=None)
def _composed_block_kernel(
    nfft: int,
    hop: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
):
    """[L, hop] block-Toeplitz kernel folding frame map + OLA, f64.

    The composed per-frame map M (see `_composed_roundtrip_basis`) plus the
    overlap-add is, per output hop-block, one linear map over the
    L = (R-1)*hop + nfft input samples that any frame touching the block
    reads (R = nfft/hop):

        y[b*hop + s] = sum_tau x[b*hop + tau - (R-1)*hop] * K[tau, s]
        K[tau, s]    = sum_r M[tau - (R-1)*hop + r*hop, r*hop + s]
                       (terms with row index outside [0, nfft) drop)

    i.e. the OLA ride along is folded into the kernel at design time (f64:
    the COLA sum of window values is exact on host). Contraction L = 1792
    at N=1024/H=256 vs the composed frame matmul's 4096 — 2.3x fewer MACs
    per sample AND no [F, N] frame matrix in HBM.
    """
    r_count = nfft // hop
    m = _composed_roundtrip_basis(
        nfft, awin_bytes, swin_bytes, response_bytes
    ).astype(np.float64)
    ll = (r_count - 1) * hop + nfft
    k = np.zeros((ll, hop), np.float64)
    for r in range(r_count):
        rows = np.arange(nfft)  # M rows touched by frame offset r
        k[rows + (r_count - 1 - r) * hop, :] += m[:, r * hop : (r + 1) * hop]
    return np.ascontiguousarray(k.astype(np.float32))


def blocked_group_for(nfft: int, hop: int):
    """Group size G for the blocked hop-block Toeplitz kernel, or None when
    (N, hop) cannot run blocked (the support gate): hop must divide N with
    R = N/hop >= 2, and N <= MAX_MATMUL_NFFT.

    G = 2 output hop-blocks per matmul row. Any G with `G | 2*(R-1)` makes
    the kernel height L_G = (2R + G - 2)*hop an exact multiple of G*hop, so
    the kernel needs no zero-row padding and the look-ahead context equals
    the (N - hop) halo the mesh formulation already exchanges; G = 2
    divides 2*(R-1) for every R.
    """
    if not (
        nfft <= MAX_MATMUL_NFFT
        and 0 < hop < nfft
        and nfft % hop == 0
        and nfft // hop >= 2
    ):
        return None
    return 2


def composed_block_supported(nfft: int, hop: int) -> bool:
    return blocked_group_for(nfft, hop) is not None


@lru_cache(maxsize=None)
def _composed_block_kernel_grouped(
    nfft: int,
    hop: int,
    group: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
):
    """K for GROUP consecutive output hop-blocks per matmul row: the G=1
    kernel stacked block-banded, K_G[tau, g*hop + s] = K1[tau - g*hop, s].
    Larger G trades a mild MAC increase ((R+G-2)*hop + N per sample vs
    (R-1)*hop + N) for ONE chunky matmul instead of L/hop skinny ones."""
    k1 = _composed_block_kernel(
        nfft, hop, awin_bytes, swin_bytes, response_bytes
    ).astype(np.float64)
    ll = k1.shape[0]
    kg = np.zeros((ll + (group - 1) * hop, group * hop), np.float64)
    for g in range(group):
        kg[g * hop : g * hop + ll, g * hop : (g + 1) * hop] = k1
    return np.ascontiguousarray(kg.astype(np.float32))


def hopblock_apply(
    x: jnp.ndarray,  # [..., T] signal
    kern_f32: np.ndarray,  # [M*block, block] Toeplitz-laid kernel
    block: int,
    n_out: int,
    left: int,
    precision=None,
) -> jnp.ndarray:
    """Shared hop-block Toeplitz matmul runtime: pad x with `left` zeros
    (the kernel's look-back halo) plus enough right zeros, reshape to
    [..., B, block], and accumulate the M shifted-view matmuls. Returns
    [..., n_out]. Used by the blocked composed round-trip and by
    `crlot_tpu.convolve`."""
    assert kern_f32.shape[0] % block == 0, (
        f"kernel height {kern_f32.shape[0]} must be a multiple of the "
        f"block size {block} (pad with zero rows)"
    )
    mg = kern_f32.shape[0] // block
    nb = -(-n_out // block)
    right = (nb - 1 + mg) * block - left - x.shape[-1]
    x_ext = jnp.pad(x, ((0, 0),) * (x.ndim - 1) + ((left, right),))
    blocks = x_ext.reshape(x_ext.shape[:-1] + (-1, block))
    kj = jnp.asarray(kern_f32)
    acc = None
    for m in range(mg):
        term = _dot(
            blocks[..., m : m + nb, :], kj[m * block : (m + 1) * block, :],
            precision,
        )
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (nb * block,))[..., :n_out]


def blocked_runtime_kernel(
    nfft: int,
    hop: int,
    group: int,
    awin_bytes: bytes,
    swin_bytes,
    response_kern_bytes: bytes,
):
    """(kern_f32 [mg*G*hop, G*hop], mg): the grouped kernel zero-row-padded
    to a whole number of G*hop tiles — the exact runtime operand of every
    blocked formulation (one-shot, mesh, chunked streamers)."""
    gh = group * hop
    kern = _composed_block_kernel_grouped(
        nfft, hop, group, awin_bytes, swin_bytes, response_kern_bytes
    )
    mg = -(-kern.shape[0] // gh)
    if mg * gh != kern.shape[0]:
        kern = np.pad(kern, ((0, mg * gh - kern.shape[0]), (0, 0)))
    return kern, mg


def blocked_chunk_geometry(nfft: int, hop: int, group=None) -> dict:
    """Context a halo-extended streaming chunk must carry so its hop-block
    Toeplitz rows read exactly what the one-shot's rows read: output block
    bg consumes input [bg*gh - left_ctx, bg*gh - left_ctx + mg*gh). With
    G | 2(R-1) (enforced by blocked_group_for) right_ctx == N - hop — the
    same halo the mesh formulation exchanges."""
    if group is None:
        group = blocked_group_for(nfft, hop)
        assert group is not None, (nfft, hop)
    r_count = nfft // hop
    gh = group * hop
    edge = (r_count - 1) * hop
    l_g = edge + nfft + (group - 1) * hop
    mg = -(-l_g // gh)
    return {
        "group": group,
        "gh": gh,
        "mg": mg,
        "left_ctx": edge,
        "right_ctx": mg * gh - gh - edge,
        "edge": edge,
    }


def blocked_patch_span(nfft: int, hop: int) -> int:
    """Input samples an edge patch reads: the R-1 boundary frames span
    (R-2)*hop + nfft samples at the stream head (or tail)."""
    return (nfft // hop - 2) * hop + nfft


def blocked_edge_patch(
    x_region: jnp.ndarray,  # [..., (R-2)*hop + nfft] stream head/tail samples
    nfft: int,
    hop: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
    precision=None,
    side: str = "head",
) -> jnp.ndarray:
    """Exact phantom-frame edge patch shared by the offline blocked
    round-trip, the mesh formulation, and the chunked streamers: the
    UN-normalized local OLA of the R-1 real boundary frames, [..., (R-1)*hop].

    `x_region` is the FIRST (side="head") or LAST (side="tail")
    `blocked_patch_span` samples of the stream. One home for these ops is
    what makes "streamed output == one-shot output" a BIT-exactness claim:
    every caller runs the identical slice/matmul/ascending-OLA sequence
    (batch size may differ, which XLA's row-independent dots don't see).
    """
    r_count = nfft // hop
    edge = (r_count - 1) * hop
    m = jnp.asarray(
        _composed_roundtrip_basis(nfft, awin_bytes, swin_bytes, response_bytes)
    )
    frames_small = jnp.stack(
        [x_region[..., f * hop : f * hop + nfft] for f in range(r_count - 1)],
        axis=-2,
    )  # [..., R-1, N]
    of = _dot(frames_small, m, precision)
    span_l = (r_count - 2) * hop + nfft
    acc_l = jnp.zeros(of.shape[:-2] + (span_l,), jnp.float32)
    for f in range(r_count - 1):  # ascending order (OLA convention)
        acc_l = acc_l.at[..., f * hop : f * hop + nfft].add(of[..., f, :])
    return acc_l[..., :edge] if side == "head" else acc_l[..., span_l - edge :]


def roundtrip_composed_blocked(
    padded: jnp.ndarray,  # [..., T_pad] padded signal (frames fully inside)
    nfft: int,
    hop: int,
    num_frames: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
    group: int = 1,
    norm_f64=None,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """Composed per-bin round-trip INCLUDING overlap-add as hop-block
    matmuls on the raw signal: returns the UN-normalized OLA accumulation
    of length full = (num_frames-1)*hop + nfft (divide by the COLA norm and
    crop like any other OLA output).

    With `norm_f64` (the [full] f64 COLA norm), the output is NORMALIZED
    with zero extra passes over the interior: hop-aligned COLA sums are
    CONSTANT across the steady-state interior (the window's cosine
    harmonics cancel for R >= harmonics+1), so 1/norm folds into the
    kernel at f64 design time (via the per-bin response, which scales the
    composed map linearly); only the 2*(R-1)*hop edge samples — already
    recomputed exactly from boundary frames — divide by the true edge
    norm. Requires the interior norm to be constant to 1e-9 relative
    (asserted; e.g. Hann needs R >= 2, Blackman R >= 3).

    Runtime shape: R2 = L/hop matmuls of [B, hop] x [hop, hop] whose
    operands are direct shifted hop-block views of the signal — the frame
    matrix is never materialized and the OLA pass disappears into the
    matmul epilogue sum. The first/last R-1 output blocks see phantom
    frames (the kernel cannot know frame bounds), so they are recomputed
    exactly via the composed frame map on the R-1 boundary frames and
    patched in.
    """
    assert composed_block_supported(nfft, hop)
    # Head/tail patches each span R-1 blocks; with fewer than 2(R-1) frames
    # they would overlap — callers fall back to the frame formulation.
    assert num_frames >= 2 * (nfft // hop - 1)
    assert group >= 1
    wb = np.ascontiguousarray(analysis_window_f64, np.float64).tobytes()
    sb = (
        None
        if synthesis_window_f64 is None
        else np.ascontiguousarray(synthesis_window_f64, np.float64).tobytes()
    )
    rb = np.ascontiguousarray(per_bin_response, np.complex128).tobytes()
    r_count = nfft // hop
    full = (num_frames - 1) * hop + nfft  # hop | nfft => hop | full
    gh = group * hop
    edge = (r_count - 1) * hop
    norm_c = None
    if norm_f64 is not None:
        norm_arr = np.asarray(norm_f64, np.float64)
        assert norm_arr.shape[-1] >= full, (norm_arr.shape, full)
        interior = norm_arr[edge : full - edge]
        norm_c = float(interior[0])
        assert norm_c > 0 and (
            np.max(np.abs(interior - norm_c)) <= 1e-9 * norm_c
        ), "interior COLA norm not constant; cannot fold into the kernel"
        # 1/norm folds through the per-bin response (the composed map is
        # linear in it) at f64 design time; distinct bytes key a distinct
        # cached kernel.
        rb_kern = np.ascontiguousarray(
            np.asarray(per_bin_response, np.complex128) / norm_c
        ).tobytes()
    else:
        rb_kern = rb
    kern, mg = blocked_runtime_kernel(nfft, hop, group, wb, sb, rb_kern)
    x = padded[..., :full].astype(jnp.float32)
    # Group row bg reads x[bg*G*hop - (R-1)*hop : ... + mg*G*hop) with zero
    # halo on both sides.
    out = hopblock_apply(
        x, kern, gh, full, (r_count - 1) * hop, precision
    )
    # Exact edge patch: recompute the head/tail (R-1) blocks from the real
    # boundary frames (phantom-frame-free); from the UNSCALED basis so the
    # norm-folded mode can divide them by the true (position-varying)
    # edge norm. Shared ops with the chunked streamers (blocked_edge_patch)
    # so streamed-vs-one-shot stays BIT-exact.
    span_p = blocked_patch_span(nfft, hop)
    head = blocked_edge_patch(
        x[..., :span_p], nfft, hop, wb, sb, rb, precision, "head"
    )
    tail = blocked_edge_patch(
        x[..., full - span_p : full], nfft, hop, wb, sb, rb, precision,
        "tail",
    )
    if norm_c is not None:
        head = head / jnp.asarray(
            np.maximum(norm_arr[:edge], eps).astype(np.float32)
        )
        tail = tail / jnp.asarray(
            np.maximum(norm_arr[full - edge : full], eps).astype(np.float32)
        )
    out = jnp.concatenate(
        [head, out[..., edge : full - edge], tail], axis=-1
    )
    return out


def roundtrip_composed_conv(
    signal: jnp.ndarray,  # [..., T] padded signal (frames fully inside)
    nfft: int,
    hop: int,
    num_frames: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
) -> jnp.ndarray:
    """The composed response round-trip as ONE strided conv on the raw
    signal: out_frames[f, j] = sum_i signal[f*hop + i] * M[i, j] is a
    1-D convolution with kernel M and stride=hop, so XLA's conv lowering
    windows the signal internally — the [F, N] frame matrix is never
    materialized to HBM. Identical math to frame_signal +
    roundtrip_composed_matmul, through XLA's conv lowering. Kept as a
    documented formulation (and CPU-tested); NOT used by the pipeline."""
    m = jnp.asarray(
        _composed_roundtrip_basis(
            nfft,
            np.ascontiguousarray(analysis_window_f64, np.float64).tobytes(),
            None
            if synthesis_window_f64 is None
            else np.ascontiguousarray(
                synthesis_window_f64, np.float64
            ).tobytes(),
            np.ascontiguousarray(per_bin_response, np.complex128).tobytes(),
        )
    )
    x = signal.astype(jnp.float32)
    lead = x.shape[:-1]
    batch = 1
    for d in lead:
        batch *= d
    xb = x.reshape(batch, 1, x.shape[-1])  # [B, C=1, T]
    kern = m[None, :, :]  # [C_in=1, N_w, N_out] -> dims (I, W, O)
    out = jax.lax.conv_general_dilated(
        xb,
        kern,
        window_strides=(hop,),
        padding="VALID",
        dimension_numbers=("NCW", "IWO", "NWC"),
        precision=_prec(precision),
    )  # [B, F_all, N]
    out = out[:, :num_frames, :]
    return out.reshape(lead + out.shape[1:])


def roundtrip_packed_matmul(
    frames: jnp.ndarray,
    nfft: int,
    analysis_window_f64: np.ndarray,
    synthesis_window_f64=None,
    precision=None,
) -> jnp.ndarray:
    """irfft(rfft(frames * w)) as two matmuls with NO complex dtype.

    The forward basis emits [Re | Im] packed reals — exactly the layout the
    inverse basis consumes — so the identity-processing round-trip never
    interleaves into complex64 (complex conversion costs two full passes over
    the spectrum).
    """
    wb = np.asarray(analysis_window_f64, np.float64).tobytes()
    fwd = jnp.asarray(_windowed_forward_basis(nfft, wb))
    if synthesis_window_f64 is not None:
        sb = np.asarray(synthesis_window_f64, np.float64).tobytes()
        inv = jnp.asarray(_windowed_inverse_basis(nfft, sb))
    else:
        inv = jnp.asarray(_inverse_basis(nfft))
    packed = _dot(frames.astype(jnp.float32), fwd, precision)
    return _dot(packed, inv, precision)
