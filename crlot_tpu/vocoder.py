"""Phase vocoder: time-stretch and pitch-shift on the STFT pipeline.

An application layer over `stft`/`istft` (the reference toolkit
stops at the round-trip; this exercises the same machinery with mismatched
analysis/synthesis hops). Everything is vectorized over frames — the
synthesis phase recursion Ps[t] = Ps[t-1] + Hs*(w_k + princarg(dP)/Ha)
is a plain cumulative sum along the frame axis, so the whole stretch is
one jitted array program (no lax.scan, no per-frame dispatch).

Numerics: the synthesis phase is accumulated in two parts. The carrier
ramp Hs*w_k*t (which reaches millions of radians on minutes-long audio —
unrepresentable at f32 phase precision) is computed EXACTLY modulo 2*pi in
integer arithmetic: Hs*w_k*t mod 2*pi = 2*pi*((k*Hs*t) mod N)/N, reduced
as (a_k * (t mod N)) mod N with a_k = (k*Hs) mod N so every intermediate
stays below N^2 < 2^31. Only the small per-frame deviation
Hs*princarg(dP)/Ha rides the f32 cumsum (bounded by pi*Hs/Ha per frame vs
the carrier's w_k*Hs), keeping rate-1 interior reconstruction > 60 dB on
minutes-long signals instead of collapsing past ~10 s.

The whole body runs under one jax.jit, and the output is real.

Algorithm: standard phase-locking-free PV (Dolson; Laroche & Dolson '99
timescale form): analysis at hop Ha, per-bin instantaneous frequency from
the wrapped phase increment, phase re-integration at synthesis hop Hs,
resynthesis with a synthesis window and sum-w^2 COLA normalization.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import StftConfig


def _princarg(p: jnp.ndarray) -> jnp.ndarray:
    """Wrap phase to (-pi, pi]."""
    return p - 2.0 * jnp.pi * jnp.round(p / (2.0 * jnp.pi))


@partial(jax.jit, static_argnames=("cfg_a", "cfg_s"))
def _stretch_impl(signal, cfg_a: StftConfig, cfg_s: StftConfig):
    from .pipeline import istft, stft

    n = cfg_a.frame_size
    ha = cfg_a.hop_size
    hs = cfg_s.hop_size
    spec = stft(signal, cfg_a)  # [..., F, K]
    mag = jnp.abs(spec)
    phase = jnp.angle(spec)
    num_frames = spec.shape[-2]

    kk = n // 2 + 1
    k_i = jnp.arange(kk, dtype=jnp.int32)
    # Heterodyned phase increment -> per-bin frequency DEVIATION from the
    # bin carrier (rad/sample), the only part that rides the f32 cumsum.
    # The bin advance w_k*Ha (hundreds of radians) is subtracted mod 2*pi
    # via exact integer arithmetic — subtracting the raw product would cost
    # ~ULP(w_k*Ha) of phase noise per frame, which cumsums into audible
    # drift on minutes-long audio.
    wrap_k = (2.0 * jnp.pi / n) * ((k_i * (ha % n)) % n).astype(jnp.float32)
    dp = phase[..., 1:, :] - phase[..., :-1, :] - wrap_k
    dev = _princarg(dp) / ha  # [..., F-1, K]
    # Carrier ramp Hs*w_k*t, exact mod 2*pi in int32 (see module docstring).
    a_k = (jnp.arange(kk, dtype=jnp.int32) * (hs % n)) % n
    t_idx = jnp.arange(num_frames, dtype=jnp.int32) % n
    ramp = (2.0 * jnp.pi / n) * (
        (t_idx[:, None] * a_k[None, :]) % n
    ).astype(jnp.float32)  # [F, K]
    dev_sum = jnp.cumsum(hs * dev, axis=-2)
    phase_s = phase[..., :1, :] + ramp + jnp.concatenate(
        [jnp.zeros_like(phase[..., :1, :]), dev_sum], axis=-2
    )
    spec_s = jax.lax.complex(mag * jnp.cos(phase_s), mag * jnp.sin(phase_s))
    return istft(spec_s, cfg_s)


def time_stretch(
    signal: jnp.ndarray, cfg: StftConfig, rate: float
) -> jnp.ndarray:
    """Stretch duration by `rate` (>1 = longer/slower) at constant pitch.

    `cfg.hop_size` is the ANALYSIS hop; the synthesis hop is
    round(rate * hop). The config's synthesis-window flag is forced on
    (modified spectra need the tapered resynthesis + sum-w^2 norm).
    Accepts [..., T]; returns [..., T_out] with
    T_out = (F-1)*Hs + N for F analysis frames.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if cfg.frame_size > 46340:
        # The exact-mod carrier ramp reduces products to < N^2, which must
        # stay below 2^31 for int32 (x64 is disabled); past that the ramp
        # would silently wrap into garbage phase.
        raise ValueError(
            f"frame_size {cfg.frame_size} exceeds the 46340 limit of the "
            "int32 exact-mod phase ramp"
        )
    # Uncentered analysis: reflect padding (center=True) puts a TIME-REVERSED
    # copy of the signal in the first frames; their bogus instantaneous
    # frequencies enter the phase cumsum once and permanently de-cohere the
    # bins (measured: a pure tone loses half its amplitude at rate 2).
    cfg_a = dataclasses.replace(cfg, synthesis_window=True, center=False)
    ha = cfg_a.hop_size
    hs = max(1, int(round(rate * ha)))
    cfg_s = dataclasses.replace(cfg_a, hop_size=hs)
    return _stretch_impl(jnp.asarray(signal), cfg_a, cfg_s)


def pitch_shift(
    signal: jnp.ndarray,
    cfg: StftConfig,
    semitones: float,
) -> jnp.ndarray:
    """Shift pitch by `semitones` at (approximately) constant duration:
    phase-vocoder stretch by s = 2^(semitones/12), then polyphase-resample
    the stretched audio back (playing it s times faster restores duration
    and scales pitch by s). The irrational factor is approximated by a
    rational with denominator <= 64 (pitch error < ~2 cents) — resampling
    between near-coprime rates like 48000:35961 would need a polyphase
    bank with tens of thousands of branches."""
    from fractions import Fraction

    from .resample.polyphase import resample

    s = float(2.0 ** (semitones / 12.0))
    frac = Fraction(s).limit_denominator(64)
    stretched = time_stretch(signal, cfg, frac.numerator / frac.denominator)
    out = resample(stretched, frac.numerator, frac.denominator)
    t = signal.shape[-1]
    out = out[..., :t]
    pad = t - out.shape[-1]
    if pad > 0:
        out = jnp.pad(out, ((0, 0),) * (out.ndim - 1) + ((0, pad),))
    return out
