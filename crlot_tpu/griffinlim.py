"""Griffin-Lim phase reconstruction from magnitude spectrograms.

Completes the STFT application layer (round-trip, vocoder, and now
magnitude-only inversion): given |STFT(x)|, iterate
istft -> stft -> magnitude projection to recover a consistent phase.
Uses the fast momentum variant (Perraudin, Balazs & Sondergaard 2013):

    t_k   = stft(istft(c_k))
    u_k   = t_k + momentum * (t_k - t_{k-1})
    c_k+1 = mag * u_k / max(|u_k|, eps)

The whole iteration is one `lax.scan` inside a single jit, so the loop is
one launch; the final istft output is real.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .core.types import StftConfig


@partial(jax.jit, static_argnames=("cfg",))
def stft_magnitude(signal, cfg: StftConfig) -> jnp.ndarray:
    """|STFT(x)| computed inside one jit: the safe way to obtain a
    magnitude spectrogram; the complex spectrum never leaves the jit."""
    from .pipeline import stft

    return jnp.abs(stft(signal, cfg))


@partial(jax.jit, static_argnames=("cfg", "iters", "length"))
def _gl_impl(mag, cfg: StftConfig, iters: int, momentum: float,
             length, seed: int):
    from .pipeline import istft, stft

    mag = jnp.asarray(mag, jnp.float32)
    # Deterministic random initial phase (zero phase makes every frame a
    # symmetric pulse — a bad, locally-optimal start).
    key = jax.random.PRNGKey(seed)
    ph0 = jax.random.uniform(
        key, mag.shape, jnp.float32, -jnp.pi, jnp.pi
    )
    c0 = jax.lax.complex(mag * jnp.cos(ph0), mag * jnp.sin(ph0))

    def project(c):
        y = istft(c, cfg, length=length)
        return stft(y, cfg)

    def body(carry, _):
        c, t_prev = carry
        t = project(c)
        u = t + momentum * (t - t_prev)
        scale = mag / jnp.maximum(jnp.abs(u), 1e-16)
        return (scale * u, t), ()

    (c, _), _ = jax.lax.scan(
        body, (c0, jnp.zeros_like(c0)), length=iters
    )
    return istft(c, cfg, length=length)


def griffin_lim(
    mag: jnp.ndarray,
    cfg: StftConfig,
    iters: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    seed: int = 0,
) -> jnp.ndarray:
    """Reconstruct a real signal from a magnitude spectrogram
    `[..., F, nfft//2+1]` (obtain one with `stft_magnitude(x, cfg)`).
    Returns `[..., length]` (default: the exact span the frames cover)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if not 0.0 <= momentum < 1.0:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    return _gl_impl(mag, cfg, iters, momentum, length, seed)
