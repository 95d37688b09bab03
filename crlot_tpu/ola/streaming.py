"""Streaming overlap-add accumulator: a bounded ring as a functional state
machine, plus a stateful class wrapper mirroring the reference API.

Reference: dsp/ola/OLAAccumulator.{h,cc}. The C++ design (per-channel
RingBuffer + split-span axpy loops) becomes a pytree
{ring [C, L], read_pos, produced, flushed} transformed by jitted pure
functions; the two-span wrap trick is wrapped modular index arithmetic inside
one scatter-add (SURVEY.md §2.2/§2.9). The COLA norm ring is a
precomputed constant (crlot_tpu.ola.norm.build_norm_linear).

Draining semantics: `produce` only releases samples whose every overlapping
frame has been received — `available = produced - (frame - hop) - read_pos`
in steady state; `flush()` releases the tail (the reference instead extends
`produced_` by a frame, OLAAccumulator.cc:223-228, and trusts callers to
drain hop-paced; the bound here makes early-drain corruption impossible while
draining the same samples in the same order for hop-paced callers).

The device cursors are int32; the class wrapper renormalizes them by ring
multiples before overflow, so stream length is unbounded.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import OLAConfig
from .norm import build_norm_linear


class OLAStreamState(NamedTuple):
    """Ring state pytree (reference fields: OLAAccumulator.h:166-186)."""

    ring: jnp.ndarray  # f32[channels, ring_len] accumulation canvas
    read_pos: jnp.ndarray  # i32[] absolute sample cursor of next drain
    produced: jnp.ndarray  # i32[] absolute high-water mark of written samples
    flushed: jnp.ndarray  # bool[] tail-release flag


def ola_init(cfg: OLAConfig) -> OLAStreamState:
    return OLAStreamState(
        ring=jnp.zeros((cfg.channels, cfg.ring_len), dtype=jnp.float32),
        read_pos=jnp.zeros((), dtype=jnp.int32),
        produced=jnp.zeros((), dtype=jnp.int32),
        flushed=jnp.zeros((), dtype=bool),
    )


def make_norm_ring(cfg: OLAConfig, window: Optional[np.ndarray]) -> np.ndarray:
    """Normalization ring (reference: OLAAccumulator.cc:260-288): all-ones
    when no window is applied inside, else the full-coverage COLA sum."""
    if window is None or not cfg.apply_window_inside:
        return np.ones(cfg.ring_len, dtype=np.float32)
    return build_norm_linear(window, cfg.ring_len, cfg.frame_size, cfg.hop_size)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def ola_add_frame(
    state: OLAStreamState,
    frames: jnp.ndarray,  # f32[channels, frame_size]
    start_sample: jnp.ndarray,  # i32[] absolute start position
    window: Optional[jnp.ndarray],  # f32[frame_size] or None
    cfg: OLAConfig,
    gain: float | jnp.ndarray = 1.0,
    start_off: jnp.ndarray | int = 0,
    size: Optional[jnp.ndarray | int] = None,
) -> OLAStreamState:
    """Accumulate one (possibly partial) windowed frame into the ring.

    Reference: `add_frame_SoA` (OLAAccumulator.cc:54-122). Ring position
    start_sample + i receives frames[:, start_off + i] * window[start_off + i]
    * gain for i in [0, size); size defaults to frame_size - start_off and is
    clamped like the reference (:81-83). Partial frames are expressed as a
    mask so every call shares one trace.
    """
    n = cfg.frame_size
    size = n - jnp.asarray(start_off) if size is None else jnp.asarray(size)
    start_off = jnp.asarray(start_off, dtype=jnp.int32)
    size = jnp.minimum(jnp.asarray(size, dtype=jnp.int32), n - start_off)

    j = jnp.arange(n, dtype=jnp.int32)
    valid = (j >= start_off) & (j < start_off + size)
    vals = frames * jnp.asarray(gain, dtype=frames.dtype)
    if window is not None:
        vals = vals * window
    vals = jnp.where(valid[None, :], vals, 0.0)

    # Ring target of frame element j is start_sample + (j - start_off).
    idx = jnp.mod(start_sample - start_off + j, cfg.ring_len)
    ring = state.ring.at[:, idx].add(vals)
    produced = jnp.maximum(state.produced, start_sample + size)
    return OLAStreamState(ring, state.read_pos, produced, state.flushed)


def ola_available(state: OLAStreamState, cfg: OLAConfig) -> jnp.ndarray:
    """Samples safe to drain: written and no longer awaiting overlaps."""
    tail = cfg.frame_size - cfg.hop_size
    safe_end = jnp.where(state.flushed, state.produced, state.produced - tail)
    return jnp.maximum(safe_end - state.read_pos, 0)


@partial(jax.jit, static_argnames=("cfg", "n"), donate_argnums=(0,))
def ola_produce(
    state: OLAStreamState,
    norm_ring: jnp.ndarray,  # f32[ring_len]
    cfg: OLAConfig,
    n: int,
):
    """Drain up to `n` samples: out = ring/max(norm, eps), ring slots zeroed.

    Reference: `produce` (OLAAccumulator.cc:162-221) — the divide-and-clear
    single pass is what lets the ring be reused indefinitely
    (kernels normalize_and_clear, dsp/ola/kernels.cc:30-36). Returns
    (state, out f32[channels, n], count i32[]); out[:, count:] is zeros.
    """
    count = jnp.minimum(ola_available(state, cfg), n).astype(jnp.int32)
    j = jnp.arange(n, dtype=jnp.int32)
    valid = j < count
    idx = jnp.mod(state.read_pos + j, cfg.ring_len)
    acc = state.ring[:, idx]
    norm = jnp.maximum(norm_ring[idx], jnp.float32(cfg.eps))
    out = jnp.where(valid[None, :], acc / norm, 0.0)
    # Clear only the drained slots (valid mask) so unproduced overlap survives.
    cleared = jnp.where(valid[None, :], 0.0, acc)
    ring = state.ring.at[:, idx].set(cleared)
    return (
        OLAStreamState(ring, state.read_pos + count, state.produced, state.flushed),
        out,
        count,
    )


def ola_flush(state: OLAStreamState) -> OLAStreamState:
    """Release the overlap tail for draining (reference flush intent,
    OLAAccumulator.cc:223-228)."""
    return state._replace(flushed=jnp.ones((), dtype=bool))


class OLAAccumulator:
    """Stateful wrapper mirroring the reference class API
    (OLAAccumulator.h:55-217): set_window / add_frame_soa / push_frame_aos /
    produce / flush / reset + peak meter. Internally everything is the jitted
    functional core above.

    PERFORMANCE WARNING: this class is the API-parity layer, NOT the fast
    path. Every add_frame_soa/produce is one device dispatch, so a
    per-frame loop through this class runs
    orders of magnitude slower than the batched pipeline
    (`pipeline.round_trip` — all frames in one program) or the streaming
    scan (`streaming_pipeline.streaming_round_trip_blocks` — one dispatch
    per multi-frame block). Use those for throughput; use this class for
    reference-shaped integrations and tests.
    """

    def __init__(self, cfg: OLAConfig) -> None:
        self.cfg = cfg
        self._window: Optional[np.ndarray] = None
        self._norm = jnp.asarray(make_norm_ring(cfg, None))
        self._state = ola_init(cfg)
        self._peak = 0.0
        self._cursor_shift = 0  # host-side absolute offset (overflow guard)

    # --- configuration (reference: OLAAccumulator.cc:38-52) ---

    def set_window(self, window: np.ndarray) -> None:
        w = np.asarray(window, dtype=np.float32)
        if w.shape != (self.cfg.frame_size,):
            raise ValueError(
                f"window length {w.shape} != frame_size ({self.cfg.frame_size},)"
            )
        self._window = w
        self._norm = jnp.asarray(make_norm_ring(self.cfg, w))

    @property
    def window(self) -> Optional[np.ndarray]:
        return self._window

    # --- accumulate ---

    def _effective_window(self, window) -> Optional[jnp.ndarray]:
        # Reference window policy (OLAAccumulator.cc:81-83): inside-config
        # uses the internal copy; otherwise the caller's, else none.
        if self.cfg.apply_window_inside:
            if self._window is None:
                return None
            return jnp.asarray(self._window)
        return None if window is None else jnp.asarray(window, dtype=jnp.float32)

    def add_frame_soa(
        self,
        ch_frames: np.ndarray,  # [channels, frame_size] (SoA)
        start_sample: int,
        start_off: int = 0,
        size: Optional[int] = None,
        gain: float = 1.0,
        window: Optional[np.ndarray] = None,
    ) -> None:
        frames = jnp.asarray(ch_frames, dtype=jnp.float32)
        if frames.shape != (self.cfg.channels, self.cfg.frame_size):
            raise ValueError(
                f"frames shape {frames.shape} != "
                f"({self.cfg.channels}, {self.cfg.frame_size})"
            )
        if size is None:
            size = self.cfg.frame_size - start_off
        size = min(size, self.cfg.frame_size - start_off)  # clamp like :81-83
        start_sample -= self._cursor_shift  # map caller-absolute -> state frame
        if start_sample + size - int(self._state.read_pos) > self.cfg.ring_len:
            raise ValueError(
                "frame overruns the ring: drain with produce() first "
                f"(start={start_sample}, size={size}, "
                f"read_pos={int(self._state.read_pos)}, "
                f"ring_len={self.cfg.ring_len})"
            )
        self._state = ola_add_frame(
            self._state,
            frames,
            jnp.asarray(start_sample, dtype=jnp.int32),
            self._effective_window(window),
            self.cfg,
            gain=gain,
            start_off=start_off,
            size=size,
        )

    def push_frame_aos(
        self,
        interleaved: np.ndarray,  # [frame_size * channels] interleaved
        start_sample: int,
        gain: float = 1.0,
        window: Optional[np.ndarray] = None,
    ) -> None:
        """AoS entry: deinterleave then SoA path (reference:
        push_frame_AoS, OLAAccumulator.cc:124-160 + aos_to_soa.cc:7-18)."""
        flat = np.asarray(interleaved, dtype=np.float32).reshape(
            self.cfg.frame_size, self.cfg.channels
        )
        self.add_frame_soa(flat.T, start_sample, gain=gain, window=window)

    # --- drain ---

    def produce(self, n: int) -> np.ndarray:
        """Drain up to n ready samples -> [channels, count]."""
        self._state, out, count = ola_produce(self._state, self._norm, self.cfg, n)
        count = int(count)
        result = np.asarray(out[:, :count])
        if count:
            self._peak = max(self._peak, float(np.max(np.abs(result[0]))))
        # Renormalize absolute cursors before int32 overflow (~12 h @ 48 kHz):
        # shifting both by a ring multiple preserves every modular index and
        # the produced-read_pos difference.
        read_pos = int(self._state.read_pos)
        if read_pos > (1 << 30):
            shift = (read_pos // self.cfg.ring_len) * self.cfg.ring_len
            self._state = self._state._replace(
                read_pos=self._state.read_pos - shift,
                produced=self._state.produced - shift,
            )
            self._cursor_shift += shift
        return result

    def available(self) -> int:
        return int(ola_available(self._state, self.cfg))

    def flush(self) -> None:
        self._state = ola_flush(self._state)

    def reset(self) -> None:
        """Zero rings/cursors/meter and drop the window (reference:
        OLAAccumulator.cc:230-247)."""
        self._state = ola_init(self.cfg)
        self._window = None
        self._norm = jnp.asarray(make_norm_ring(self.cfg, None))
        self._peak = 0.0
        self._cursor_shift = 0

    @property
    def meter_peak(self) -> float:
        return self._peak
