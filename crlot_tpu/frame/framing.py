"""Batch framing: signal -> [num_frames, frame_size] matrix.

Reference: dsp/frame/FrameQueue.{h,cc} (offline AoS framing with centered
padding) — accelerator formulation per SURVEY.md §2.4: one gather with index
matrix `start[i] + j` over the padded signal, which XLA fuses with the window
multiply and feeds straight into the batched rFFT. No per-frame copies exist.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.padding import pad_signal
from ..core.types import FrameSpec, PadMode


def num_frames(spec: FrameSpec, signal_len: int) -> int:
    """Frame-count law (reference: FrameQueue.cc:99-115): max n with
    n*hop + tail <= padded_len, tail = max(frame - hop, 0)."""
    return spec.num_frames(signal_len)


def hop_block_frames(
    x: jnp.ndarray, frame_size: int, hop: int, n_frames: int
) -> jnp.ndarray:
    """Gather-free framing core: `[..., L] -> [..., n_frames, frame_size]`
    with frame f = x[f*hop : f*hop + frame_size].

    Reshapes the signal into hop blocks and stacks R = ceil(N/H) shifted
    [F, hop] views. Gathers with arbitrary index matrices are slow; this
    lowers to R static slices + one concat, all contiguous copies (the
    hop-block dual of the OLA formulation in ola/reference.py).
    """
    r = -(-frame_size // hop)
    blocks_needed = n_frames + r - 1
    need = blocks_needed * hop
    if x.shape[-1] < need:
        widths = [(0, 0)] * (x.ndim - 1) + [(0, need - x.shape[-1])]
        x = jnp.pad(x, widths)
    blocks = x[..., :need].reshape(*x.shape[:-1], blocks_needed, hop)
    parts = [blocks[..., i : i + n_frames, :] for i in range(r)]
    return jnp.concatenate(parts, axis=-1)[..., :frame_size]


@partial(jax.jit, static_argnums=(1,))
def _frame_gather(padded: jnp.ndarray, spec: FrameSpec) -> jnp.ndarray:
    n_frames = spec.num_frames(padded.shape[-1] - 2 * spec.pad_amount)
    return hop_block_frames(padded, spec.frame_size, spec.hop_size, n_frames)


def frame_signal(signal: jnp.ndarray, spec: FrameSpec) -> jnp.ndarray:
    """Slice `signal[..., L]` into `[..., num_frames, frame_size]`.

    With `spec.center=True`, pads frame_size//2 on both sides first using
    `spec.pad_mode` (reference: FrameQueue.cc:68-97). Raises if the (padded)
    signal yields zero frames, matching the reference's ctor throw on
    too-short input.
    """
    signal = jnp.asarray(signal)
    length = signal.shape[-1]
    if spec.num_frames(length) <= 0:
        raise ValueError(
            f"signal of length {length} yields no frames for frame_size="
            f"{spec.frame_size}, hop={spec.hop_size}, center={spec.center}"
        )
    padded = pad_signal(
        signal, spec.pad_amount, spec.pad_amount, spec.pad_mode, spec.pad_value
    )
    return _frame_gather(padded, spec)


def frame_start_indices(spec: FrameSpec, signal_len: int) -> jnp.ndarray:
    """Start sample (in the unpadded signal) of each frame; frame i covers
    `[i*hop - pad, i*hop - pad + frame)`."""
    n = spec.num_frames(signal_len)
    return jnp.arange(n) * spec.hop_size - spec.pad_amount


def frame_windowed(
    signal: jnp.ndarray,
    spec: FrameSpec,
    window: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """Frame and apply the analysis window in one fused op.

    This is the jnp formulation of the reference's hot loop "frame x window"
    (bench/e2e_benchmark.cc:154-156); XLA fuses the gather and multiply into
    one pass. A Pallas variant lives in crlot_tpu.ola.kernels.
    """
    frames = frame_signal(signal, spec)
    if window is None:
        return frames
    window = jnp.asarray(window, dtype=frames.dtype)
    if window.shape != (spec.frame_size,):
        raise ValueError(
            f"window shape {window.shape} != (frame_size,) = ({spec.frame_size},)"
        )
    return frames * window


__all__ = [
    "num_frames",
    "frame_signal",
    "frame_windowed",
    "frame_start_indices",
    "FrameSpec",
    "PadMode",
]


class FrameQueue:
    """Batch framing with per-frame accessors (reference: dsp/frame/
    FrameQueue.{h,cc}): precomputes the whole [num_frames, frame_size] matrix
    up front; `get_frame` returns a view, `copy_frame` a copy, and
    `get_all_frames` the full matrix (AoS contiguity: frame i+1 follows
    frame i). Prefer `frame_signal` for pipelines; this class exists for the
    random-access pattern (performance_benchmark.cc:181-229)."""

    def __init__(self, signal, spec: FrameSpec) -> None:
        import numpy as np

        self.spec = spec
        self._frames = np.asarray(frame_signal(signal, spec))
        if self._frames.ndim != 2:
            raise ValueError("FrameQueue takes a 1-D signal")

    def __len__(self) -> int:
        return self._frames.shape[0]

    @property
    def num_frames(self) -> int:
        return self._frames.shape[0]

    def get_frame(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(f"frame {i} out of range [0, {len(self)})")
        return self._frames[i]

    def copy_frame(self, i: int):
        return self.get_frame(i).copy()

    def get_all_frames(self):
        return self._frames


def aos_to_soa(interleaved, channels: int):
    """Deinterleave AoS samples [frames*channels] -> SoA [channels, frames]
    (reference: dsp/ola/aos_to_soa.cc:7-18, channel-major)."""
    import numpy as np

    flat = np.asarray(interleaved)
    if flat.ndim != 1 or flat.size % channels != 0:
        raise ValueError(
            f"interleaved length {flat.shape} not divisible by {channels}"
        )
    return np.ascontiguousarray(flat.reshape(-1, channels).T)


def soa_to_aos(soa):
    """Interleave SoA [channels, frames] -> AoS [frames*channels]."""
    import numpy as np

    x = np.asarray(soa)
    if x.ndim != 2:
        raise ValueError("soa must be 2-D [channels, frames]")
    return np.ascontiguousarray(x.T).reshape(-1)
