"""Single-device STFT / iSTFT / round-trip pipeline.

Reference workload: bench/e2e_benchmark.cc:138-186 (streaming) and
bench/performance_benchmark.cc:174-246 (offline batch) — the accelerator
formulation is the offline batch shape: all frames as one [F, N] matrix ->
one batched rFFT -> spectral processing -> one batched irFFT -> one
vectorized OLA (SURVEY.md §3.5).

Single-window discipline (SURVEY.md §7): `stft` applies the analysis window
exactly once; `istft` divides by the matching COLA norm (sum w, or sum w^2
when a synthesis window is configured). The reference's double-window bug
(docs/PHASE0_AUDIT.md BLK-01) cannot be expressed through this API.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import StftConfig
from .fft import dispatch as _fft
from .frame.framing import frame_windowed
from .ola.fused import ola_normalized
from .ola.norm import edge_norm
from .window.windows import get_window


@lru_cache(maxsize=None)
def _window_np(cfg: StftConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.frame_size, cfg.periodic)


@lru_cache(maxsize=None)
def _window_f64(cfg: StftConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.frame_size, cfg.periodic, dtype=np.float64)


@lru_cache(maxsize=None)
def _norm_np(cfg: StftConfig, num_frames: int, out_len: int) -> np.ndarray:
    w = _window_np(cfg).astype(np.float64)
    contrib = w * w if cfg.synthesis_window else w
    return edge_norm(contrib, cfg.hop_size, num_frames, out_len)


def stft(signal: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """`[..., L]` real -> `[..., F, nfft//2+1]` complex spectrogram.

    The analysis window rides inside the DFT basis on the matmul path
    (zero-cost); other backends multiply explicitly (fft.dispatch).
    """
    frames = frame_windowed(signal, cfg.frame_spec, None)
    return _fft.rfft_windowed(
        frames, cfg.frame_size, _window_f64(cfg), backend=cfg.fft_backend,
        precision=_fft.to_lax_precision(cfg.fft_precision),
    )


@partial(
    jax.jit,
    static_argnames=("sr_in", "sr_out", "cfg", "taps_per_phase", "atten_db"),
)
def resampled_stft(
    signal: jnp.ndarray,
    sr_in: int,
    sr_out: int,
    cfg: StftConfig,
    taps_per_phase: Optional[int] = None,
    atten_db: float = 120.0,
) -> jnp.ndarray:
    """Polyphase resample -> frame -> window -> rFFT as ONE jitted program.

    BASELINE.json config 3's "fused with framing (replaces r8brain)": the
    reference streams r8brain chunks through a host loop and only then frames
    (main/main.cc:257-287); here the strided-conv resampler and the framed
    DFT compile into a single XLA program, so the resampled intermediate
    never round-trips through HBM-to-host and the frame gather fuses onto
    the conv output. Returns the `[..., F, nfft//2+1]` spectrogram at the
    OUTPUT rate sr_out.
    """
    from .resample.polyphase import resample

    y = resample(jnp.asarray(signal), sr_in, sr_out, taps_per_phase, atten_db)
    return stft(y, cfg)


def istft(
    spec: jnp.ndarray,
    cfg: StftConfig,
    length: Optional[int] = None,
) -> jnp.ndarray:
    """`[..., F, nfft//2+1]` complex -> `[..., length]` real reconstruction.

    Default length is the exact span an stft of that many frames covers
    (minus center padding when cfg.center).
    """
    num_frames = spec.shape[-2]
    frames = _fft.irfft(
        spec, cfg.frame_size, backend=cfg.fft_backend,
        precision=_fft.to_lax_precision(cfg.fft_precision),
    )
    if cfg.synthesis_window:
        frames = frames * jnp.asarray(_window_np(cfg))
    pad = cfg.frame_spec.pad_amount
    full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    if length is None:
        length = full - 2 * pad
    norm = jnp.asarray(_norm_np(cfg, num_frames, full))
    out = ola_normalized(frames, norm, cfg.hop_size, full, cfg.eps)
    return out[..., pad : pad + length]


def blocked_norm_fold(cfg: StftConfig, num_frames: int):
    """(norm_arr, full, edge, fold_ok) for the blocked round-trip's
    NORM-FOLD mode: fold_ok when the interior COLA sum is constant — true
    for any window whose hop-aligned cosine harmonics cancel at this R —
    so 1/norm folds into the kernel at design time and only the
    2*(R-1)*hop edge samples divide by the true position-varying norm.
    Interior/edge norm VALUES are num_frames-independent (each position
    sums the same window slices in the same order), which is what lets the
    chunked streamer reproduce the one-shot's normalization bit-exactly
    without knowing the stream length."""
    full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    norm_arr = _norm_np(cfg, num_frames, full)
    edge = (cfg.frame_size // cfg.hop_size - 1) * cfg.hop_size
    interior = norm_arr[edge : full - edge]
    fold_ok = (
        interior.size > 0
        and interior[0] > 0
        and np.max(np.abs(interior - interior[0])) <= 1e-9 * interior[0]
    )
    return norm_arr, full, edge, fold_ok


def blocked_composed_round_trip(
    signal: jnp.ndarray, cfg: StftConfig, per_bin: np.ndarray
) -> jnp.ndarray:
    """round_trip's blocked (hop-block Toeplitz) branch as a standalone,
    gate-free program (docs/DESIGN.md 'blocked identity'), exposed so the
    chunked blocked streamers (streaming_pipeline) and CPU tests can target
    the EXACT one-shot program their bit-exactness claims reference. Caller
    contract: composed_block_supported(N, hop) and
    num_frames >= 2*(N/hop - 1)."""
    from .core.padding import pad_signal
    from .fft.matmul_backend import (
        blocked_group_for,
        roundtrip_composed_blocked,
    )

    spec_ = cfg.frame_spec
    num_frames = spec_.num_frames(signal.shape[-1])
    w64 = _window_f64(cfg)
    padded = pad_signal(
        signal, spec_.pad_amount, spec_.pad_amount,
        spec_.pad_mode, spec_.pad_value,
    )
    norm_arr, full, edge, fold_ok = blocked_norm_fold(cfg, num_frames)
    out = roundtrip_composed_blocked(
        padded, cfg.frame_size, cfg.hop_size, num_frames, w64,
        per_bin, w64 if cfg.synthesis_window else None,
        precision=_fft.to_lax_precision(cfg.fft_precision),
        group=blocked_group_for(cfg.frame_size, cfg.hop_size),
        norm_f64=norm_arr if fold_ok else None,
        eps=cfg.eps,
    )
    pad = spec_.pad_amount
    if not fold_ok:
        out = out / jnp.maximum(jnp.asarray(norm_arr), cfg.eps)
    return out[..., pad : pad + signal.shape[-1]]


def round_trip(
    signal: jnp.ndarray,
    cfg: StftConfig,
    spectral_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
) -> jnp.ndarray:
    """stft -> (spectral processing) -> istft, output same length as input.

    With spectral_fn=None this is the reference's identity round-trip
    (bench/e2e_benchmark.cc:161-163) and must reconstruct at > 60 dB SNR.
    Identity and fixed per-bin responses (EQ, FIR, fractional delay) run as
    the blocked hop-block Toeplitz matmuls where `fft.dispatch.blocked_route`
    picks them and the shape allows (`blocked_composed_round_trip`);
    everything else runs stft -> fn -> istft.
    """
    from .fft.matmul_backend import MAX_MATMUL_NFFT, composed_block_supported
    from .spectral import resolve_per_bin_response

    signal = jnp.asarray(signal)
    n, hop = cfg.frame_size, cfg.hop_size
    if (
        n <= MAX_MATMUL_NFFT
        and _fft.blocked_route(cfg.fft_backend, n, hop)
        and composed_block_supported(n, hop)
        and cfg.frame_spec.num_frames(signal.shape[-1]) >= 2 * (n // hop - 1)
    ):
        per_bin = (
            np.ones(n // 2 + 1)
            if spectral_fn is None
            else resolve_per_bin_response(spectral_fn, n)
        )
        if per_bin is not None:
            return blocked_composed_round_trip(signal, cfg, per_bin)
    spec = stft(signal, cfg)
    if spectral_fn is not None:
        spec = spectral_fn(spec)
    return istft(spec, cfg, length=signal.shape[-1])
