"""FFT backend dispatch: which formulation and which matmul precision.

Reference analog: the `FFT_BACKEND=kissfft` build-time config_setting
(dsp/fft/BUILD.bazel:4-7) becomes a runtime enum (SURVEY.md §5 'Config'):

  - XLA:    jnp.fft (cuFFT on the GPU; any N)
  - MATMUL: DFT-as-matmul bases (N <= MAX_MATMUL_NFFT; Cooley-Tukey
            matmuls for larger powers of two)
  - AUTO:   XLA for transforms; a fixed per-bin round trip (identity, EQ,
            FIR) takes the blocked hop-block Toeplitz matmuls where
            `blocked_route` says so.

Measured on an NVIDIA H100 80GB HBM3 (PERF.md, 700 W limit; the
alternating pairs at 400 W): cuFFT beats the
folded DFT matmuls for a bare forward transform (0.263 vs 0.449 ms for
60 s of 48 kHz at N=1024/H=256) and for the framed and nonlinear round
trips. The blocked round trip (identity, 64 channels x 60 s) beats cuFFT
at N = 256 (5.34 vs 11.30 ms) and N = 1024 (8.83 vs 11.35 ms) with
N/hop = 4, and at N = 1024 with N/hop = 8 (12.86 vs 21.62 ms); it loses
at N = 2048 (13.90 vs 11.44 ms) and N = 4096 (16.62 vs 11.39 ms), whose
kernels do work that grows with N where cuFFT's grows with log N, and at
N/hop = 2 (0.465 vs 0.301 ms, mono).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import FftBackend, FftPrecision
from . import ct_backend as _ct
from . import matmul_backend as _mm

# Each tier as an explicit dot algorithm on the GPU, where an unspecified
# f32 dot may run in TF32. Measured on the H100 at 700 W (identity round
# trip, blocked route, N=1024/H=256): HIGH = three bf16 passes, 113 dB SNR in
# 0.403 ms; HIGHEST = true f32, 182 dB in 0.538 ms. TF32 (75 dB in
# 0.367 ms) clears the 60 dB gate but is 20 dB short of the ~95 dB (16-bit
# audio's range) HIGH has promised, so no tier maps to it. Other backends
# compute every tier in true f32 (the CPU rejects some algorithms on
# degenerate dots).
_GPU_PRESETS = {
    FftPrecision.HIGH: jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    FftPrecision.HIGHEST: jax.lax.DotAlgorithmPreset.F32_F32_F32,
}


def to_lax_precision(p):
    """Map FftPrecision (or None = backend default) to the dot algorithm
    the DFT/Toeplitz matmuls run with."""
    if p is None:
        return None
    if jax.default_backend() != "gpu":
        return jax.lax.DotAlgorithmPreset.F32_F32_F32
    return _GPU_PRESETS[p]


# Where AUTO takes the blocked round trip on a GPU: the frame sizes and
# overlaps (N/hop) at which it was measured faster than cuFFT, and no
# others (module docstring).
_BLOCKED_NFFT = (256, 1024)
_BLOCKED_OVERLAP = (4, 8)


def blocked_route(backend: FftBackend, nfft: int, hop: int) -> bool:
    """Whether a fixed per-bin round trip (identity, EQ, FIR) runs as the
    blocked hop-block Toeplitz matmuls: MATMUL asks for it, XLA refuses it,
    AUTO takes it on a GPU for 256 <= N <= 1024 with 4 <= N/hop <= 8.
    Callers still check `composed_block_supported`."""
    if backend == FftBackend.MATMUL:
        return True
    if backend == FftBackend.XLA:
        return False
    return (jax.default_backend() == "gpu"
            and _BLOCKED_NFFT[0] <= nfft <= _BLOCKED_NFFT[1]
            and _BLOCKED_OVERLAP[0] <= nfft // hop <= _BLOCKED_OVERLAP[1])


def _is_pow2(n: int) -> bool:
    return n > 0 and not (n & (n - 1))


def _pick(backend: FftBackend, nfft: int) -> FftBackend:
    """A bare transform runs as matmuls only when MATMUL asks for it."""
    return FftBackend.MATMUL if backend == FftBackend.MATMUL else FftBackend.XLA


def _mm_rfft(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    # Direct DFT matmul up to the basis-size cap; two-stage Cooley-Tukey
    # matmuls beyond (power-of-two sizes).
    if nfft <= _mm.MAX_MATMUL_NFFT:
        if nfft % 2 == 0:
            return _mm.rfft_folded(x, nfft, precision)
        return _mm.rfft_matmul(x, nfft, precision)
    if _is_pow2(nfft):
        return _ct.rfft_ct(x, nfft, precision)
    return jnp.fft.rfft(x, n=nfft, axis=-1)


def _mm_irfft(x: jnp.ndarray, nfft: int, precision=None) -> jnp.ndarray:
    if nfft <= _mm.MAX_MATMUL_NFFT:
        if nfft % 2 == 0:
            return _mm.irfft_folded(x, nfft, precision)
        return _mm.irfft_matmul(x, nfft, precision)
    if _is_pow2(nfft):
        return _ct.irfft_ct(x, nfft, precision)
    return jnp.fft.irfft(x, n=nfft, axis=-1)


def rfft(
    x: jnp.ndarray, nfft: int, backend: FftBackend = FftBackend.AUTO,
    precision=None,
) -> jnp.ndarray:
    if _pick(backend, nfft) == FftBackend.MATMUL:
        return _mm_rfft(x, nfft, precision)
    return jnp.fft.rfft(x, n=nfft, axis=-1)


def irfft(
    x: jnp.ndarray, nfft: int, backend: FftBackend = FftBackend.AUTO,
    precision=None,
) -> jnp.ndarray:
    if _pick(backend, nfft) == FftBackend.MATMUL:
        return _mm_irfft(x, nfft, precision)
    return jnp.fft.irfft(x, n=nfft, axis=-1)


__all__ = ["FftBackend", "rfft", "irfft"]


def rfft_windowed(
    x: jnp.ndarray,
    nfft: int,
    window_f64,
    backend: FftBackend = FftBackend.AUTO,
    precision=None,
) -> jnp.ndarray:
    """rfft(x * window): on the direct-matmul path the window folds into the
    DFT basis (zero-cost); other paths multiply then transform.

    `window_f64` is the float64 host design of the window (the f32 working
    window is its cast), so folding loses no precision vs multiply-then-DFT.
    """
    import numpy as np

    from . import matmul_backend as _mmb

    if _pick(backend, nfft) == FftBackend.MATMUL and nfft <= _mm.MAX_MATMUL_NFFT:
        if nfft % 2 == 0:
            return _mmb.rfft_windowed_folded(x, nfft, window_f64, precision)
        return _mmb.rfft_windowed_matmul(x, nfft, window_f64, precision)
    w = jnp.asarray(np.asarray(window_f64, dtype=np.float32))
    return rfft(x * w, nfft, backend, precision)


def fft_complex(
    x: jnp.ndarray, nfft: int, backend: FftBackend = FftBackend.AUTO,
    precision=None,
) -> jnp.ndarray:
    """Complex forward FFT with backend dispatch (CT matmuls for power-of-2
    sizes on the MATMUL path, jnp.fft otherwise)."""
    if _pick(backend, nfft) == FftBackend.MATMUL and _is_pow2(nfft):
        return _ct.fft_ct(x, nfft, precision)
    return jnp.fft.fft(x, n=nfft, axis=-1)


def ifft_complex(
    x: jnp.ndarray, nfft: int, backend: FftBackend = FftBackend.AUTO,
    precision=None,
) -> jnp.ndarray:
    if _pick(backend, nfft) == FftBackend.MATMUL and _is_pow2(nfft):
        return _ct.ifft_ct(x, nfft, precision)
    return jnp.fft.ifft(x, n=nfft, axis=-1)
