"""Cooley-Tukey matmul FFT: large-N rFFT/irFFT as two matmul stages.

The direct DFT-as-matmul (matmul_backend.py) needs an [N, N+2] basis — fine
to N=4096, quadratic beyond. This backend factors the transform: a real rFFT
of length N packs even/odd samples into a complex signal of length M = N/2,
runs a two-stage Cooley-Tukey FFT (M = M1*M2: DFT_M1 matmul, twiddle
multiply, DFT_M2 matmul), and unpacks with the standard half-size real-FFT
post-twiddle. FLOPs drop from O(N^2) to O(N*(M1+M2)) per frame with both
stages shaped as dense matmuls (M1, M2 chosen near sqrt(M), powers of two).

Complex arithmetic is decomposed into real matmuls;
bases are designed in float64 and cast to float32; matmuls run at
Precision.HIGHEST. Verified against numpy to f32 round-off in tests.

Derivation notes: index n = M2*n1 + n2, k = k1 + M1*k2 gives
Z[k1,k2] = DFT_M2( twiddle * DFT_M1(z) ), output laid out [k2, k1];
inverse uses Z[k] = (S + D)/2 with S = X[k] + conj(X[M-k]),
D = -i*conj(e_k)*(conj(X[M-k]) - X[k]), then ifft(z) = conj(fft(conj(z)))/M.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_PRECISION = jax.lax.Precision.HIGHEST


def factor(m: int) -> tuple:
    """Split m = m1*m2 with m2 the largest power of two <= sqrt(m)."""
    if m & (m - 1):
        raise ValueError(f"CT backend requires power-of-two sizes, got {m}")
    m2 = 1
    while m2 * m2 * 4 <= m:
        m2 *= 2
    return m // m2, m2


@lru_cache(maxsize=None)
def _ct_consts(m1: int, m2: int):
    m = m1 * m2
    d1 = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m1)) / m1)
    d2 = np.exp(-2j * np.pi * np.outer(np.arange(m2), np.arange(m2)) / m2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m2)) / m)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return (
        f32(d1.real), f32(d1.imag),
        f32(d2.real), f32(d2.imag),
        f32(tw.real), f32(tw.imag),
    )


@lru_cache(maxsize=None)
def _pack_consts(n: int):
    m = n // 2
    k = np.arange(m + 1)
    e = np.exp(-2j * np.pi * k / n)
    return (
        np.asarray(e.real, dtype=np.float32),
        np.asarray(e.imag, dtype=np.float32),
    )


def _ct_fft(zr: jnp.ndarray, zi: jnp.ndarray, m1: int, m2: int,
            precision=None):
    """Two-stage complex FFT on real/imag pairs [..., M] -> [..., M]."""
    prec = _PRECISION if precision is None else precision
    d1r, d1i, d2r, d2i, twr, twi = map(jnp.asarray, _ct_consts(m1, m2))
    ar = zr.reshape(*zr.shape[:-1], m1, m2)
    ai = zi.reshape(*zi.shape[:-1], m1, m2)
    # Stage 1: B = D1 @ A (contract over n1, the second-to-last axis).
    ein = lambda mat, x: jnp.einsum(  # noqa: E731
        "kn,...nm->...km", mat, x, precision=prec
    )
    br = ein(d1r, ar) - ein(d1i, ai)
    bi = ein(d1r, ai) + ein(d1i, ar)
    # Twiddle (elementwise complex multiply).
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # Stage 2: Z = C @ D2 (contract over n2, the last axis).
    ein2 = lambda x, mat: jnp.einsum(  # noqa: E731
        "...km,ml->...kl", x, mat, precision=prec
    )
    zr2 = ein2(cr, d2r) - ein2(ci, d2i)
    zi2 = ein2(cr, d2i) + ein2(ci, d2r)
    # k = k1 + m1*k2: output index [k2, k1].
    m = m1 * m2
    zr2 = jnp.swapaxes(zr2, -1, -2).reshape(*zr.shape[:-1], m)
    zi2 = jnp.swapaxes(zi2, -1, -2).reshape(*zi.shape[:-1], m)
    return zr2, zi2


def rfft_ct(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Real [..., nfft] -> complex64 [..., nfft//2+1] via packed CT FFT."""
    m = nfft // 2
    m1, m2 = factor(m)
    x = x.astype(jnp.float32)
    zr, zi = x[..., 0::2], x[..., 1::2]
    fr, fi = _ct_fft(zr, zi, m1, m2, precision)
    # Extend with Z[M] = Z[0]; Zc[k] = conj(Z[M-k]).
    fr_ext = jnp.concatenate([fr, fr[..., :1]], axis=-1)
    fi_ext = jnp.concatenate([fi, fi[..., :1]], axis=-1)
    zcr = fr_ext[..., ::-1]
    zci = -fi_ext[..., ::-1]
    er, ei = map(jnp.asarray, _pack_consts(nfft))
    # X = 0.5 (Z + Zc) - 0.5 i e (Z - Zc)
    sr, si = fr_ext + zcr, fi_ext + zci
    dr, di = fr_ext - zcr, fi_ext - zci
    # i*e*(dr + i di) = (i er - ei)(...) => real: -(er*di + ei*dr),
    # imag: er*dr - ei*di
    xr = 0.5 * (sr + (er * di + ei * dr))
    xi = 0.5 * (si - (er * dr - ei * di))
    return jax.lax.complex(xr, xi)


def irfft_ct(spec: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Complex [..., nfft//2+1] -> real [..., nfft] (includes 1/N)."""
    m = nfft // 2
    m1, m2 = factor(m)
    xr = spec.real.astype(jnp.float32)
    xi = spec.imag.astype(jnp.float32)
    # conj(X[M-k]) for k = 0..M-1 (index M-k runs M..1).
    xmr = xr[..., ::-1][..., : m]
    xmi = -xi[..., ::-1][..., : m]
    xr_k, xi_k = xr[..., :m], xi[..., :m]
    er_full, ei_full = map(jnp.asarray, _pack_consts(nfft))
    er, ei = er_full[:m], ei_full[:m]
    sr, si = xr_k + xmr, xi_k + xmi
    gr, gi = xmr - xr_k, xmi - xi_k
    # D = -i * conj(e) * G;  conj(e) = er - i ei
    # -i*(er - i ei) = -ei - i er  =>  D = (-ei - i er)(gr + i gi)
    dr = -ei * gr + er * gi
    di = -er * gr - ei * gi
    zr = 0.5 * (sr + dr)
    zi = 0.5 * (si + di)
    # ifft(z) = conj(fft(conj(z))) / M
    fr, fi = _ct_fft(zr, -zi, m1, m2, precision)
    tr, ti = fr / m, -fi / m
    out = jnp.stack([tr, ti], axis=-1).reshape(*tr.shape[:-1], nfft)
    return out


def fft_ct(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Complex FFT [..., nfft] -> [..., nfft] via the two-stage CT matmuls."""
    m1, m2 = factor(nfft)
    zr, zi = _ct_fft(
        x.real.astype(jnp.float32), x.imag.astype(jnp.float32), m1, m2,
        precision,
    )
    return jax.lax.complex(zr, zi)


def ifft_ct(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    """Inverse complex FFT (includes 1/N): conj(fft(conj(x)))/N."""
    m1, m2 = factor(nfft)
    zr, zi = _ct_fft(
        x.real.astype(jnp.float32), -x.imag.astype(jnp.float32), m1, m2,
        precision,
    )
    return jax.lax.complex(zr / nfft, -zi / nfft)
