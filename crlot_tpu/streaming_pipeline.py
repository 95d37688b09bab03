"""Bounded-memory streaming round-trip: lax.scan over hop blocks.

SURVEY.md §5 'Long-context': unbounded-length streams with bounded state —
the reference's Framer compacting buffer + OLA ring (framer.cc:169-179,
OLAAccumulator.cc:249-258) become a `lax.scan` whose carry is the ring pytree.
One scan step consumes `block_frames` new frames and emits `block_frames*hop`
finished samples; per-chip memory stays O(ring + block) regardless of stream
length, and the whole stream is ONE device program (no per-frame dispatch).

This is the single-device analog of the time-block sharded pipeline; for
multi-chip, shard the scan's frame batches by channel (distributed module).
"""

from __future__ import annotations

import logging
from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger("crlot_tpu.streaming")

from .core.types import StftConfig
from .fft import dispatch as _fft
from .ola.norm import build_norm_linear
from .window.windows import get_window


@partial(
    jax.jit,
    static_argnames=("cfg", "block_frames", "spectral_fn", "return_carry"),
)
def streaming_round_trip_blocks(
    frame_blocks: jnp.ndarray,  # [num_blocks, block_frames, N] raw frames
    cfg: StftConfig,
    block_frames: int,
    spectral_fn=None,
    carry_tail=None,  # [N - hop] tail from a previous call (chunk chaining)
    return_carry: bool = False,
):
    """Process framed blocks through window->rFFT->irFFT->OLA with a carried
    ring; returns [num_blocks * block_frames * hop] samples (steady-state
    normalized; the first frame's leading hop is emitted on the first step).

    The carry is the overlap tail: after OLA-ing a block spanning
    block_frames*hop + (N - hop) samples, the last (N - hop) stay in the
    carry and seed the next block (earliest-frame-first order, so output is
    bit-identical to the offline pipeline's interior).
    """
    n, hop = cfg.frame_size, cfg.hop_size
    halo = n - hop
    window_np = get_window(cfg.window, n, cfg.periodic)
    window_f64 = get_window(cfg.window, n, cfg.periodic, dtype=np.float64)
    window = jnp.asarray(window_np)
    norm_np = build_norm_linear(
        window_np.astype(np.float64) ** 2 if cfg.synthesis_window else window_np,
        -(-halo // hop) * hop + block_frames * hop,
        n,
        hop,
    )
    block_len = block_frames * hop
    norm = jnp.asarray(norm_np[:block_len])
    eps = jnp.float32(cfg.eps)

    from .ola.reference import overlap_add

    from .core.types import FftBackend
    from .fft.matmul_backend import (
        MAX_MATMUL_NFFT,
        roundtrip_composed_matmul,
        roundtrip_folded_tiled,
        tiled_supported,
    )
    from .spectral import resolve_per_bin_response

    on_matmul = _fft._pick(cfg.fft_backend, n) == FftBackend.MATMUL
    per_bin = (
        resolve_per_bin_response(spectral_fn, n)
        if spectral_fn is not None and on_matmul and n <= MAX_MATMUL_NFFT
        else None
    )
    on_packed = on_matmul and tiled_supported(n)
    prec = _fft.to_lax_precision(cfg.fft_precision)
    syn64 = window_f64 if cfg.synthesis_window else None

    def step(carry_tail, frames):
        # frames: [block_frames, N]; round-trip per block. On the matmul
        # path this is the packed tiled formulation — or, with a fixed
        # per-bin response, ONE composed [N, N] matmul (the offline
        # pipeline's blocked Toeplitz form folds the OLA into the kernel,
        # which conflicts with the scan's carried OLA tail — composed is
        # the streaming-safe formulation) — with no complex
        # interleave; other cases go through rfft -> spectral_fn -> irfft.
        if per_bin is not None:
            out_f = roundtrip_composed_matmul(
                frames, n, window_f64, per_bin, syn64, precision=prec
            )
        elif on_packed and (
            spectral_fn is None or hasattr(spectral_fn, "packed")
        ):
            if spectral_fn is None:
                out_f = roundtrip_folded_tiled(
                    frames, n, window_f64, syn64, precision=prec
                )
            else:
                from .fft.matmul_backend import (
                    irfft_folded_tiled_parts,
                    packed_to_tiled_parts,
                    rfft_folded_tiled_parts,
                    tiled_parts_to_packed,
                )

                re512, re_nyq, im_eff = rfft_folded_tiled_parts(
                    frames, n, window, prec
                )
                re, im = spectral_fn.packed(*tiled_parts_to_packed(
                    re512, re_nyq, im_eff
                ))
                out_f = irfft_folded_tiled_parts(
                    *packed_to_tiled_parts(re, im, n), n, prec
                )
                if cfg.synthesis_window:
                    out_f = out_f * window
        else:
            spec = _fft.rfft_windowed(
                frames, n, window_f64, backend=cfg.fft_backend,
                precision=prec,
            )
            if spectral_fn is not None:
                spec = spectral_fn(spec)
            out_f = _fft.irfft(
                spec, n, backend=cfg.fft_backend, precision=prec
            )
            if cfg.synthesis_window:
                out_f = out_f * window
        acc = overlap_add(
            out_f, hop, out_len=block_len + halo,
            init_head=carry_tail,
        )
        emitted = acc[..., :block_len] / jnp.maximum(norm, eps)
        new_tail = acc[..., block_len:]
        return new_tail, emitted

    init_tail = (
        jnp.zeros(frame_blocks.shape[2:-1] + (halo,), dtype=jnp.float32)
        if carry_tail is None
        else jnp.asarray(carry_tail, jnp.float32)
    )
    final_tail, blocks_out = jax.lax.scan(step, init_tail, frame_blocks)
    out = blocks_out.reshape(-1)
    return (out, final_tail) if return_carry else out


# ---------------------------------------------------------------------------
# Blocked (hop-block Toeplitz) chunk streaming.
#
# The blocked one-shot formulation (pipeline.blocked_composed_round_trip)
# runs in the chunk streamers too. The blocked kernel is
# overlap-save-shaped — output block bg
# reads input [bg*gh - left_ctx, bg*gh - left_ctx + mg*gh) — so the chunk
# protocol it wants is exactly halo-extended chunks: carry `left_ctx`
# look-back and `right_ctx` look-ahead of REAL neighbor samples
# (fft.matmul_backend.blocked_chunk_geometry) and every chunk's rows compute
# the IDENTICAL full-kernel-row dots the one-shot computes. Chunked output
# is therefore BIT-identical to the blocked one-shot over the whole stream
# (matmul rows are batch-independent), with the stream head/tail
# phantom-frame patches applied by the first/last chunk only
# (blocked_edge_patch — the same ops the one-shot runs).
#
# Reference anchor: the reference's own hot loop is streaming
# (bench/e2e_benchmark.cc:138-186); its Framer retains (N - hop) overlap
# across push() calls (dsp/frame/framer.cc:164) — left_ctx/right_ctx is the
# chunk-level, kernel-shaped generalization.
# ---------------------------------------------------------------------------


def _resolve_blocked_per_bin(cfg: StftConfig, spectral_fn):
    """Per-bin response bytes for the blocked stream (ones for identity),
    or None when the spectral fn is not a fixed per-bin response."""
    from .spectral import resolve_per_bin_response

    n = cfg.frame_size
    if spectral_fn is None:
        per_bin = np.ones(n // 2 + 1)
    else:
        per_bin = resolve_per_bin_response(spectral_fn, n)
        if per_bin is None:
            return None
    return np.ascontiguousarray(per_bin, np.complex128).tobytes()


@partial(jax.jit, static_argnames=("cfg", "rb", "head", "tail"))
def _blocked_chunk(lctx, mid, rctx, cfg: StftConfig, rb: bytes,
                   head: bool, tail: bool):
    """One halo-extended blocked chunk: [..., S] output for the `mid`
    samples, bit-identical to the blocked one-shot's same output span.
    lctx: [..., left_ctx] predecessor tail (zeros at the stream head);
    rctx: [..., right_ctx] successor head (zeros at the stream tail)."""
    from .fft.matmul_backend import (
        blocked_edge_patch,
        blocked_patch_span,
        hopblock_apply,
    )

    c = _blocked_stream_consts(cfg, rb)
    n, hop = cfg.frame_size, cfg.hop_size
    edge, gh = c["edge"], c["gh"]
    prec = _fft.to_lax_precision(cfg.fft_precision)
    s = mid.shape[-1]
    x_ext = jnp.concatenate([lctx, mid, rctx], axis=-1)
    # Interior: the one-shot's hopblock rows verbatim (same kernel cache
    # entry, same m-ordered accumulation; the one-shot's zero padding
    # beyond the stream bounds IS lctx/rctx zeros at the edge chunks).
    out = hopblock_apply(x_ext, c["kern"], gh, s, left=0, precision=prec)
    if c["interior_norm_tile"] is not None:
        # Non-fold mode (e.g. synthesis-window w^2 norms, whose f32 interior
        # wobbles ~1 ULP and fails the fold gate exactly like the one-shot's
        # own gate): divide by the hop-PERIODIC interior norm — the same f32
        # values the one-shot's divide-after applies at these positions
        # (chunk phase is preserved because S % hop == 0 and the interior
        # starts at the hop-aligned position `edge`).
        out = out / jnp.tile(jnp.asarray(c["interior_norm_tile"]), s // hop)
    span_p = blocked_patch_span(n, hop)
    if head:
        region = x_ext[..., edge : edge + span_p]
        p = blocked_edge_patch(
            region, n, hop, c["wb"], c["sb"], rb, prec, "head"
        ) / jnp.asarray(c["head_norm"])
        out = jnp.concatenate([p, out[..., edge:]], axis=-1)
    if tail:
        region = x_ext[..., edge + s - span_p : edge + s]
        p = blocked_edge_patch(
            region, n, hop, c["wb"], c["sb"], rb, prec, "tail"
        ) / jnp.asarray(c["tail_norm"])
        out = jnp.concatenate([out[..., : s - edge], p], axis=-1)
    return out


@lru_cache(maxsize=None)
def _blocked_stream_consts(cfg: StftConfig, rb: bytes) -> dict:
    """Design-time constants of the blocked chunk program, derived to be
    BITWISE identical to what pipeline.blocked_composed_round_trip builds
    for any stream length: interior/edge COLA norm values are
    num_frames-independent (pipeline.blocked_norm_fold), so a reference
    frame count stands in for the unknown stream length."""
    from .fft.matmul_backend import (
        blocked_chunk_geometry,
        blocked_runtime_kernel,
    )
    from .pipeline import _window_f64, blocked_norm_fold

    n, hop = cfg.frame_size, cfg.hop_size
    r = n // hop
    geo = blocked_chunk_geometry(n, hop)
    nf_ref = 2 * (r - 1) + 2
    norm_ref, full_ref, edge, fold_ok = blocked_norm_fold(cfg, nf_ref)
    w64 = _window_f64(cfg)
    wb = np.ascontiguousarray(w64, np.float64).tobytes()
    sb = wb if cfg.synthesis_window else None
    norm64 = np.asarray(norm_ref, np.float64)
    per_bin = np.frombuffer(rb, np.complex128)
    tile = None
    if fold_ok:
        # Same fold the one-shot applies: 1/interior-norm into the kernel.
        norm_c = float(norm64[edge])
        rb_kern = np.ascontiguousarray(
            np.asarray(per_bin, np.complex128) / norm_c
        ).tobytes()
    else:
        # Non-fold (divide-after) mode: interior norm is hop-PERIODIC
        # (verified: identical summand order per residue), so one [hop]
        # tile reproduces the one-shot's divide-after values everywhere
        # in the interior.
        rb_kern = rb
        tile = np.maximum(norm64[edge : edge + hop], cfg.eps).astype(
            np.float32
        )
    kern, mg = blocked_runtime_kernel(n, hop, geo["group"], wb, sb, rb_kern)
    return {
        **geo,
        "kern": kern,
        "wb": wb,
        "sb": sb,
        "interior_norm_tile": tile,
        "head_norm": np.maximum(norm64[:edge], cfg.eps).astype(np.float32),
        "tail_norm": np.maximum(
            norm64[full_ref - edge : full_ref], cfg.eps
        ).astype(np.float32),
    }


def blocked_stream_supported(
    cfg: StftConfig, chunk_samples=None, spectral_fn=None
) -> bool:
    """Gate for the blocked chunk streamer: the blocked route
    (`fft.dispatch.blocked_route`), supported (N, hop), per-bin (or
    identity) response, and — when chunk_samples is
    given — G*hop-aligned chunks long enough that the head/tail patches
    never overlap (S >= 2*edge + N covers even a single-chunk stream's
    num_frames >= 2*(R-1) one-shot gate)."""
    from .fft.matmul_backend import (
        blocked_chunk_geometry,
        composed_block_supported,
    )

    n, hop = cfg.frame_size, cfg.hop_size
    if cfg.center:
        return False
    if not _fft.blocked_route(cfg.fft_backend, n, hop):
        return False
    if not composed_block_supported(n, hop):
        return False
    if _resolve_blocked_per_bin(cfg, spectral_fn) is None:
        return False
    if chunk_samples is not None:
        geo = blocked_chunk_geometry(n, hop)
        if chunk_samples % geo["gh"] != 0:
            return False
        if chunk_samples < 2 * geo["edge"] + n:
            return False
    return True


class BlockedChunkStreamer:
    """Resumable single-device chunk streamer running the BLOCKED headline
    formulation (r5; closes the r4 verdict's 26x one-shot-vs-stream gap).

    Feed equal-shape, G*hop-aligned [..., S] chunks with `feed()` (returns
    the reconstructed PREDECESSOR chunk — one chunk of latency, since the
    kernel's look-ahead needs the successor's head) and drain the last
    chunk with `finish()`. Concatenated output over the whole stream is
    BIT-identical to `pipeline.blocked_composed_round_trip` (the
    center=False round_trip identity/EQ path wherever `blocked_route`
    picks it) over the unbroken stream — asserted in
    tests/test_streaming_pipeline.py.
    The carried state (previous chunk + left_ctx tail + head flag) is a
    dict of numpy arrays: `state()`/`load_state()` checkpoint a multi-hour
    stream and resume bit-identically in a fresh process.
    """

    def __init__(self, cfg: StftConfig, spectral_fn=None) -> None:
        if cfg.center:
            raise ValueError("blocked streaming is uncentered (center=False)")
        rb = _resolve_blocked_per_bin(cfg, spectral_fn)
        if rb is None or not blocked_stream_supported(cfg, None, spectral_fn):
            raise ValueError(
                "config not supported by the blocked streamer; use "
                "streaming_round_trip_blocks (scan formulation) instead"
            )
        self.cfg = cfg
        self._rb = rb
        c = _blocked_stream_consts(cfg, rb)
        self._edge, self._rctx_n = c["edge"], c["right_ctx"]
        self._gh = c["gh"]
        self._prev = None  # previous chunk (device array)
        self._lctx = None  # tail of the chunk before that
        self._first = True
        self._finished = False
        self._s = None

    def _check(self, chunk):
        s = chunk.shape[-1]
        if self._s is None:
            n = self.cfg.frame_size
            if s % self._gh != 0 or s < 2 * self._edge + n:
                raise ValueError(
                    f"chunk length {s} must be a multiple of G*hop "
                    f"({self._gh}) and >= 2*(N-hop) + N ({2 * self._edge + n})"
                )
            self._s = s
        elif s != self._s:
            raise ValueError(f"chunk length changed: {s} != {self._s}")

    def feed(self, chunk, force: bool = True):
        """Feed one [..., S] chunk; returns the reconstructed PREDECESSOR
        chunk, or None on the first call. `force=False` returns the
        un-forced device array (async dispatch: the caller overlaps this
        chunk's compute with its own work — the depth-2 prefetch hook)."""
        if self._finished:
            raise RuntimeError(
                "feed() after finish(): create a new BlockedChunkStreamer "
                "(or load_state a checkpoint) to continue"
            )
        chunk = jnp.asarray(chunk, jnp.float32)
        self._check(chunk)
        out = None
        if self._prev is not None:
            out = _blocked_chunk(
                self._lctx, self._prev, chunk[..., : self._rctx_n],
                self.cfg, self._rb, self._first, False,
            )
            self._first = False
            if force:
                out = np.asarray(out)
            self._lctx = self._prev[..., -self._edge :]
        else:
            self._lctx = jnp.zeros(
                chunk.shape[:-1] + (self._edge,), jnp.float32
            )
        self._prev = chunk
        return out

    def finish(self, force: bool = True):
        """Drain the final buffered chunk (ends the stream)."""
        self._finished = True
        if self._prev is None:
            return None
        rctx = jnp.zeros(
            self._prev.shape[:-1] + (self._rctx_n,), jnp.float32
        )
        out = _blocked_chunk(
            self._lctx, self._prev, rctx, self.cfg, self._rb,
            self._first, True,
        )
        self._first = False
        self._lctx = self._prev[..., -self._edge :]
        self._prev = None
        if force:
            out = np.asarray(out)
        return out

    def state(self) -> dict:
        """Picklable/npz-able checkpoint of the stream position."""
        return {
            "prev": None if self._prev is None else np.asarray(self._prev),
            "lctx": None if self._lctx is None else np.asarray(self._lctx),
            "first": self._first,
            "s": self._s,
        }

    def load_state(self, st: dict) -> None:
        self._finished = False
        self._prev = (
            None if st["prev"] is None
            else jnp.asarray(st["prev"], jnp.float32)
        )
        self._lctx = (
            None if st["lctx"] is None
            else jnp.asarray(st["lctx"], jnp.float32)
        )
        self._first = bool(st["first"])
        self._s = None if st["s"] is None else int(st["s"])


def streaming_round_trip(
    signal: np.ndarray,
    cfg: StftConfig,
    block_frames: int = 64,
    spectral_fn=None,
) -> Tuple[np.ndarray, int]:
    """Stream a long 1-D signal through the scan pipeline.

    Returns (output, valid_from): output[t] reconstructs signal[t] for
    t >= valid_from (the first `halo` samples lack full window coverage in
    steady-state normalization, like the reference's streaming OLA warm-up).
    `spectral_fn` follows round_trip's contract (fixed per-bin responses
    ride the composed one-matmul path; packed ops skip complex interleave).
    """
    if cfg.center:
        raise ValueError("streaming pipeline is uncentered (center=False)")
    n, hop = cfg.frame_size, cfg.hop_size
    x = np.asarray(signal, dtype=np.float32)
    num_frames = max((len(x) - (n - hop)) // hop, 0)
    blocks = num_frames // block_frames
    if blocks == 0:
        raise ValueError(
            f"signal too short: {len(x)} samples < "
            f"{block_frames * hop + (n - hop)} needed for one block"
        )
    f = blocks * block_frames
    idx = np.arange(f)[:, None] * hop + np.arange(n)[None, :]
    frames = jnp.asarray(x[idx].reshape(blocks, block_frames, n))
    out = np.asarray(
        streaming_round_trip_blocks(frames, cfg, block_frames, spectral_fn)
    )
    return out, n - hop


def process_wav_file(
    infile: str,
    outfile: str,
    cfg: StftConfig,
    spectral_fn=None,
    block_frames: int = 64,
    blocks_per_chunk: int = 16,
    bits: int = 16,
) -> int:
    """File-to-file streaming round-trip at bounded memory: read a WAV in
    hop-aligned chunks, run each through the scan pipeline with the OLA
    tail carried across chunks (so output equals an unbroken stream), and
    write incrementally. Handles any file length and channel count; frames
    past EOF are zero-padded (reference Framer ZERO_PAD semantics,
    dsp/frame/framer.cc:128-161). Returns samples written per channel.

    Warm-up/cool-down: the first and last (frame_size - hop) samples have
    partial window coverage (steady-state normalization), matching
    streaming_round_trip's `valid_from` contract.
    """
    from .io.wav import WavReader, WavWriter

    if cfg.center:
        raise ValueError("streaming pipeline is uncentered (center=False)")
    n, hop = cfg.frame_size, cfg.hop_size
    chunk_frames = block_frames * blocks_per_chunk
    chunk_out = chunk_frames * hop

    reader = WavReader(infile)
    channels = reader.channels
    total = reader.num_frames
    logger.info(
        "stream %s -> %s: %d ch, %d frames @ %d Hz, N=%d H=%d, "
        "chunk=%d frames",
        infile, outfile, channels, total, reader.sample_rate, n, hop,
        chunk_frames,
    )
    with WavWriter(
        outfile, channels, reader.sample_rate, bits=bits
    ) as writer:
        carries = [None] * channels
        pos = 0
        written = 0
        while written < total:
            span = (chunk_frames - 1) * hop + n
            raw = reader.read(pos, min(span, max(total - pos, 0)))
            if raw.shape[-1] < span:  # EOF: zero-pad trailing frames
                raw = np.pad(raw, [(0, 0), (0, span - raw.shape[-1])])
            idx = (
                np.arange(chunk_frames)[:, None] * hop
                + np.arange(n)[None, :]
            )
            out_ch = []
            for c in range(channels):
                frames = jnp.asarray(
                    raw[c][idx].reshape(blocks_per_chunk, block_frames, n)
                )
                out, carries[c] = streaming_round_trip_blocks(
                    frames, cfg, block_frames, spectral_fn,
                    carry_tail=carries[c], return_carry=True,
                )
                out_ch.append(np.asarray(out))
            chunk = np.stack(out_ch)[:, : min(chunk_out, total - written)]
            writer.write(chunk)
            written += chunk.shape[-1]
            pos += chunk_out
            logger.debug(
                "stream %s: %d/%d samples written", outfile, written, total
            )
    logger.info("stream %s done: %d samples/channel written", outfile, written)
    return written
