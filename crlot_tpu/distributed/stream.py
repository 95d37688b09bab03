"""Unbounded-length sharded streaming: chunk-level overlap-save.

BASELINE.json config 5: hour-long multi-channel streams, time-blocks sharded
over the mesh, end-to-end samples/s. A stream of any length is processed in
fixed-shape chunks (one compile), each extended with `L_ctx >= frame_size`
samples of real context on both sides so every kept output sample sees its
full frame coverage — the chunk-level analog of the reference Framer's
overlap retention (framer.cc:164). Kept regions tile the stream exactly and
the result is bit-identical to one giant `sharded_round_trip` over the whole
stream (asserted in tests), while host memory stays O(chunk).

On a multi-host slice the same code runs under `jax.distributed` with the
mesh's time axis laid across hosts: the intra-chunk halos ride ICI, and only
the per-chunk context refeed crosses DCN (via the host).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Iterator, Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

from ..core.types import StftConfig
from .mesh import CHANNEL_AXIS, TIME_AXIS, auto_mesh
from .sharded_pipeline import _norm_np, blocked_per_bin, sharded_round_trip


def _ctx_len(cfg: StftConfig, n_time: int) -> int:
    unit = n_time * cfg.hop_size
    return -(-cfg.frame_size // unit) * unit


@partial(jax.jit, static_argnames=("cfg", "rb", "side"))
def _stream_edge_patch(region, norm_edge, cfg: StftConfig, rb: bytes, side):
    """Stream-head/tail phantom-frame patch for the BLOCKED mesh stream:
    the shared `blocked_edge_patch` ops (identical to what the one-shot
    mesh round-trip computes on its edge devices) divided by the true
    position-varying edge norm (identical to the one-shot's
    `acc / max(norm, eps)` at those positions)."""
    from ..fft import dispatch as _fft
    from ..fft.matmul_backend import blocked_edge_patch
    from ..window.windows import get_window

    n, hop = cfg.frame_size, cfg.hop_size
    w64 = get_window(cfg.window, n, cfg.periodic, dtype=np.float64)
    wb = np.ascontiguousarray(w64, np.float64).tobytes()
    sb = wb if cfg.synthesis_window else None
    prec = _fft.to_lax_precision(cfg.fft_precision)
    p = blocked_edge_patch(region, n, hop, wb, sb, rb, prec, side)
    return p / jnp.maximum(norm_edge, jnp.float32(cfg.eps))


@lru_cache(maxsize=None)
def _jit_mesh_rt(cfg: StftConfig, mesh, spectral_fn):
    """Module-level cache of the jitted full-validity mesh call: a fresh
    ShardedStreamer (e.g. a checkpoint restore, or a benchmark loop
    constructing streamers per run) must reuse the compiled program, not
    re-trace it."""
    return jax.jit(
        lambda v: sharded_round_trip(v, cfg, mesh, spectral_fn)
    )


def _blocked_stream_mode(cfg, mesh, spectral_fn, s: int):
    """Blocked-formulation config for a chunked mesh stream of [C, s]
    chunks, or None when the gate does not hold. Mirrors the one-shot's
    `blocked_per_bin` gate evaluated at the halo-extended chunk shape, so
    every chunk (head, middle, tail) runs the SAME blocked program the
    one-shot runs, with the stream head/tail patches applied by the
    streamer (the in-mesh patches land in the discarded context region)."""
    from ..streaming_pipeline import _resolve_blocked_per_bin

    n, hop = cfg.frame_size, cfg.hop_size
    n_time = mesh.shape[TIME_AXIS]
    l_ctx = _ctx_len(cfg, n_time)
    ext = s + 2 * l_ctx
    edge = n - hop
    if s < 2 * edge + n:  # head/tail patches must never overlap
        return None
    rb = _resolve_blocked_per_bin(cfg, spectral_fn)
    if rb is None:
        return None
    nf = (ext - n) // hop + 1
    per_bin = blocked_per_bin(
        cfg, spectral_fn, t_block=ext // n_time, num_frames=nf
    )
    if per_bin is None:
        return None
    r = n // hop
    nf_ref = 2 * (r - 1) + 2
    span_ref = (nf_ref - 1) * hop + n
    norm_ref = _norm_np(cfg, nf_ref, span_ref)  # edge values nf-independent
    return {
        "rb": rb,
        "head_norm": np.asarray(norm_ref[:edge], np.float32),
        "tail_norm": np.asarray(norm_ref[span_ref - edge :], np.float32),
    }


def sharded_stream(
    x: np.ndarray,  # [channels, T] (host array; any length)
    cfg: StftConfig,
    mesh: Optional[Mesh] = None,
    chunk_samples: int = 1 << 20,
    spectral_fn: Optional[Callable] = None,
) -> np.ndarray:
    """Process a long stream chunk-by-chunk on the mesh; returns [C, T]."""
    if mesh is None:
        mesh = auto_mesh()
    n_time = mesh.shape[TIME_AXIS]
    n_ch = mesh.shape[CHANNEL_AXIS]
    n, hop = cfg.frame_size, cfg.hop_size
    x = np.asarray(x, dtype=np.float32)
    channels, total = x.shape
    if channels % n_ch != 0:
        raise ValueError(f"channels ({channels}) % mesh channel ({n_ch}) != 0")
    unit = n_time * hop
    s = max(chunk_samples // unit, 1) * unit
    if s // n_time < n:
        s = -(-n * n_time // unit) * unit  # ensure block >= frame
    l_ctx = _ctx_len(cfg, n_time)
    ext = s + 2 * l_ctx

    out = np.zeros_like(x)
    for start in range(0, total, s):
        ext_start = start - l_ctx
        buf = np.zeros((channels, ext), dtype=np.float32)
        lo = max(0, ext_start)
        hi = min(total, ext_start + ext)
        if hi > lo:
            buf[:, lo - ext_start : hi - ext_start] = x[:, lo:hi]
        valid = int(np.clip(total - ext_start, 0, ext))
        y = np.asarray(
            sharded_round_trip(
                jnp.asarray(buf), cfg, mesh, spectral_fn,
                valid_len=valid,
                valid_start=max(0, -ext_start),  # first chunk: stream head
                allow_blocked=False,  # one formulation for every chunk
            )
        )
        keep = min(s, total - start)
        out[:, start : start + keep] = y[:, l_ctx : l_ctx + keep]
    return out


class ShardedStreamer:
    """Explicit-state resumable chunk streamer over the mesh.

    Feed equal-shape hop-aligned [C, S] chunks with `feed()` (returns the
    reconstructed predecessor chunk, one chunk of latency — the context
    refeed needs the successor's head) and drain the last chunk with
    `finish()`. The carried state — previous chunk, its left context, and
    the stream-head flag — is an ordinary dict of numpy arrays
    (`state()` / `load_state()`), so a multi-hour stream can checkpoint
    mid-flight and resume in a fresh process with BIT-IDENTICAL output
    (the reference has no streaming checkpoint at all; SURVEY.md §5
    'Checkpoint / resume' makes it a requirement here).
    """

    def __init__(
        self,
        cfg: StftConfig,
        mesh: Optional[Mesh] = None,
        spectral_fn: Optional[Callable] = None,
        allow_blocked: bool = True,
    ) -> None:
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else auto_mesh()
        self.spectral_fn = spectral_fn
        self.allow_blocked = allow_blocked
        self._n_time = self.mesh.shape[TIME_AXIS]
        self._l_ctx = _ctx_len(cfg, self._n_time)
        self._prev: Optional[np.ndarray] = None  # previous chunk
        self._tail: Optional[np.ndarray] = None  # chunk before that
        self._first = True  # next processed chunk is the stream head
        self._s: Optional[int] = None
        self._finished = False  # finish() ends the stream; feed() raises
        self._mode = None  # blocked-mode dict, or None; set at first feed
        self._jit_blocked = None  # jitted full-validity mesh call (async)

    def _process(self, left, mid, right, valid_from_mid, is_tail=False):
        l_ctx = self._l_ctx
        ext = np.concatenate([left[:, -l_ctx:], mid, right[:, :l_ctx]], axis=1)
        if self._mode is not None:
            # BLOCKED (headline) formulation, r5: every chunk runs the
            # full-validity blocked program (the left/right context makes
            # the kept rows read exactly what the one-shot's rows read;
            # the in-mesh phantom patches land in the discarded context),
            # and only the stream's head/tail chunks overwrite their edge
            # samples with the one-shot's exact stream-edge patches. The
            # whole chunk is ONE jitted program per (head, tail) role:
            # jit dispatch is ASYNC (the depth-p prefetch driver's overlap
            # lever; an eager shard_map call blocks on CPU hosts), and the
            # in-jit patches partition over channels exactly like the
            # one-shot's in-mesh patches (multihost-safe: no host fetch).
            mode = self._mode
            n, hop = self.cfg.frame_size, self.cfg.hop_size
            edge = n - hop
            s = mid.shape[1]
            from jax.sharding import NamedSharding, PartitionSpec

            if self._jit_blocked is None:
                self._jit_blocked = _jit_mesh_rt(
                    self.cfg, self.mesh, self.spectral_fn
                )
            ext_g = jax.device_put(
                ext,
                NamedSharding(
                    self.mesh, PartitionSpec(CHANNEL_AXIS, TIME_AXIS)
                ),
            )
            y = self._jit_blocked(ext_g)
            if self._first or is_tail:
                # Stream-edge patches as STANDALONE jitted ops on a local
                # region (NOT folded into the big mesh program: fusion
                # there lowers the tiny patch matmul differently, 1 ULP
                # off the one-shot's in-mesh patch). The values are
                # replicated to a global array so the eager .at[].set
                # works on multihost meshes too.
                from ..fft.matmul_backend import blocked_patch_span

                span_p = blocked_patch_span(n, hop)
                rep = NamedSharding(
                    self.mesh, PartitionSpec(CHANNEL_AXIS, None)
                )
                if self._first:
                    p = _stream_edge_patch(
                        jnp.asarray(ext[:, l_ctx : l_ctx + span_p]),
                        jnp.asarray(mode["head_norm"]), self.cfg,
                        mode["rb"], "head",
                    )
                    p = jax.device_put(np.asarray(p), rep)
                    y = y.at[:, l_ctx : l_ctx + edge].set(p)
                if is_tail:
                    end = l_ctx + s
                    p = _stream_edge_patch(
                        jnp.asarray(ext[:, end - span_p : end]),
                        jnp.asarray(mode["tail_norm"]), self.cfg,
                        mode["rb"], "tail",
                    )
                    p = jax.device_put(np.asarray(p), rep)
                    y = y.at[:, end - edge : end].set(p)
            self._first = False
            return y[:, l_ctx : l_ctx + s]
        y = sharded_round_trip(
            jnp.asarray(ext), self.cfg, self.mesh, self.spectral_fn,
            valid_len=l_ctx + valid_from_mid,
            valid_start=l_ctx if self._first else 0,
            # Fallback (non-per-bin fns, unaligned shapes): the masked
            # frame formulation — one formulation for every chunk keeps
            # the chunk-vs-one-shot bit-exactness invariant.
            allow_blocked=False,
        )
        self._first = False
        return y[:, l_ctx : l_ctx + mid.shape[1]]

    def feed(
        self, chunk: np.ndarray, force: bool = True
    ) -> Optional[np.ndarray]:
        """Feed one [C, S] chunk; returns the reconstructed PREDECESSOR
        chunk (one chunk of latency — the context refeed needs this
        chunk's head). `force=False` returns the un-forced device array
        instead of numpy: JAX's async dispatch then overlaps this chunk's
        halo exchanges and compute with the caller's work — the depth-2
        prefetch hook the weak-scaling model's `prefetch_basis` names
        (halos are input context, so nothing serializes on the previous
        chunk's OUTPUT)."""
        if self._finished:
            # Silently continuing would reuse the drained chunk as left
            # context with no stream-head masking (advisor r3 finding).
            raise RuntimeError(
                "feed() after finish(): the stream has ended; create a new "
                "ShardedStreamer (or load_state a checkpoint) to continue"
            )
        chunk = np.asarray(chunk, dtype=np.float32)
        if self._s is None:
            self._s = chunk.shape[1]
            unit = self._n_time * self.cfg.hop_size
            if self._s % unit or self._s // self._n_time < self.cfg.frame_size:
                raise ValueError(
                    f"chunk length {self._s} must be a multiple of {unit} "
                    f"with {self._s}//{self._n_time} >= frame_size "
                    f"({self.cfg.frame_size})"
                )
            if self.allow_blocked:
                self._mode = _blocked_stream_mode(
                    self.cfg, self.mesh, self.spectral_fn, self._s
                )
            self._tail = np.zeros_like(chunk)
        elif chunk.shape[1] != self._s:
            raise ValueError(
                f"chunk length changed: {chunk.shape[1]} != {self._s}"
            )
        out = None
        if self._prev is not None:
            out = self._process(
                self._tail, self._prev, chunk, self._s + self._l_ctx
            )
            if force:
                out = np.asarray(out)
            self._tail = self._prev
        self._prev = chunk
        return out

    def finish(self, force: bool = True) -> Optional[np.ndarray]:
        """Drain the final buffered chunk (treats the stream as ended)."""
        self._finished = True
        if self._prev is None:
            return None
        out = self._process(
            self._tail, self._prev, np.zeros_like(self._prev), self._s,
            is_tail=True,
        )
        if force:
            out = np.asarray(out)
        self._tail = self._prev
        self._prev = None
        return out

    def state(self) -> dict:
        """Picklable/npz-able checkpoint of the stream position."""
        return {
            "prev": None if self._prev is None else self._prev.copy(),
            "tail": None if self._tail is None else self._tail.copy(),
            "first": self._first,
            "s": self._s,
        }

    def load_state(self, st: dict) -> None:
        self._finished = False  # a restored checkpoint resumes the stream
        self._prev = None if st["prev"] is None else np.asarray(
            st["prev"], np.float32)
        self._tail = None if st["tail"] is None else np.asarray(
            st["tail"], np.float32)
        self._first = bool(st["first"])
        self._s = None if st["s"] is None else int(st["s"])
        self._mode = (
            _blocked_stream_mode(
                self.cfg, self.mesh, self.spectral_fn, self._s
            )
            if self.allow_blocked and self._s is not None
            else None
        )


def sharded_stream_iter(
    chunks: Iterator[np.ndarray],
    cfg: StftConfig,
    mesh: Optional[Mesh] = None,
    spectral_fn: Optional[Callable] = None,
) -> Iterator[np.ndarray]:
    """Generator variant for true unbounded streams: consumes [C, S] chunks
    (all the same hop-aligned shape) and yields reconstructed [C, S] chunks
    with one chunk of latency (context refeed needs the successor's head)."""
    streamer = ShardedStreamer(cfg, mesh, spectral_fn)
    for chunk in chunks:
        out = streamer.feed(chunk)
        if out is not None:
            yield out
    out = streamer.finish()
    if out is not None:
        yield out
