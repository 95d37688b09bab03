"""XLA-backed FFT transforms with the reference's numerical contract.

Reference: dsp/fft/backends/kissfft/kissfft_adapter.cc. Contract carried over:
  - forward scrubs NaN/Inf -> 0 and |x| < 1e-30 denormals -> 0 on input
    (kissfft_adapter.cc:96-121),
  - inverse includes the 1/nfft scale (kissfft is unnormalized and the adapter
    divides, :138-167; jnp.fft.irfft/ifft are already 1/N-normalized) and
    scrubs the output,
  - REAL forward yields nfft/2+1 bins.

The denormal scrub makes results independent of whether a backend flushes
denormals, so CPU and GPU runs stay comparable.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

DENORMAL_THRESHOLD = 1e-30  # reference: kissfft_adapter.cc:101-110


def scrub(x: jnp.ndarray) -> jnp.ndarray:
    """NaN/Inf -> 0, tiny denormals -> 0 (reference: kissfft_adapter.cc:96-121).

    Applied to real and complex arrays; for complex, each component is
    scrubbed independently (matching the adapter's per-float loop).
    """
    if jnp.iscomplexobj(x):
        return jax.lax.complex(scrub(x.real), scrub(x.imag))
    x = jnp.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    return jnp.where(jnp.abs(x) < DENORMAL_THRESHOLD, 0.0, x)


@lru_cache(maxsize=None)
def _jitted(kind: str, nfft: int, do_scrub: bool):
    if kind == "rfft":

        def f(x):
            x = scrub(x) if do_scrub else x
            return jnp.fft.rfft(x, n=nfft, axis=-1)

    elif kind == "irfft":

        def f(x):
            y = jnp.fft.irfft(x, n=nfft, axis=-1)
            return scrub(y) if do_scrub else y

    elif kind == "fft":

        def f(x):
            x = scrub(x) if do_scrub else x
            return jnp.fft.fft(x, n=nfft, axis=-1)

    elif kind == "ifft":

        def f(x):
            y = jnp.fft.ifft(x, n=nfft, axis=-1)
            return scrub(y) if do_scrub else y

    else:  # pragma: no cover
        raise ValueError(kind)
    return jax.jit(f)


def rfft(x, nfft: int, do_scrub: bool = True):
    return _jitted("rfft", nfft, do_scrub)(jnp.asarray(x, dtype=jnp.float32))


def irfft(x, nfft: int, do_scrub: bool = True):
    return _jitted("irfft", nfft, do_scrub)(jnp.asarray(x, dtype=jnp.complex64))


def fft(x, nfft: int, do_scrub: bool = True):
    return _jitted("fft", nfft, do_scrub)(jnp.asarray(x, dtype=jnp.complex64))


def ifft(x, nfft: int, do_scrub: bool = True):
    return _jitted("ifft", nfft, do_scrub)(jnp.asarray(x, dtype=jnp.complex64))
