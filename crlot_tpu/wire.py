"""Born-int16 wire ingest: the blocked round-trip on integer-born operands.

Wire audio arrives int16 on the device; splitting it into two int8 limbs is
exact, so the blocked hop-block Toeplitz kernel can run as integer dots on
the wire samples without a float dequantize.

`I16BlockedStreamer` mirrors `streaming_pipeline.BlockedChunkStreamer`'s
halo-extended chunk protocol (one chunk of latency, resumable state) but
takes int16 chunks and runs the hop-block Toeplitz interior as int8xint8
-> int32 dots on exact hi/lo limbs of the wire samples. Only the small
head/tail edge-patch regions (span_p samples at the stream ends) are
dequantized to f32. Tiers:

  int8x2 (default)  two-limb ~15-bit kernel, 4 int8 dots per m-term —
                    the accuracy-conservative shape (kernel quantization
                    ~90 dB below kmax; below the int16 wire noise floor
                    for identity, and >=60 dB for per-bin EQ responses).
  int8x1            single 8-bit kernel limb, 2 int8 dots per m-term —
                    the cheaper shape. Safe for near-delta kernels
                    (identity round-trips: the wire floor dominates);
                    EQ responses flatten the rows and should use int8x2.

The integer interior is EXACTLY block-size invariant (int32 accumulation
is associative), so chunked output is bit-identical across chunk sizes —
asserted in tests/test_wire_i16.py.

Reference anchor: the reference's hot loop is the streaming e2e bench
(bench/e2e_benchmark.cc:138-186) fed from int16 WAV wire
data (io/wav.cc int16 path); the reference dequantizes on the host. Here
the wire buffer lands on device as int16 and the dequant never happens.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.types import StftConfig
from .streaming_pipeline import (
    _blocked_stream_consts,
    _resolve_blocked_per_bin,
    blocked_stream_supported,
)

_TIERS = ("int8x2", "int8x1")

# int16 full-scale: wire samples are x_f = x_i16 / 32768.
_I16_SCALE = 32768.0


def i16_limbs(x_i16: jnp.ndarray):
    """Exact hi/lo int8 limbs of int16 samples: hi*256 + lo == x.

    lo is the sign-extended low byte in [-128, 127]; hi = (x - lo) >> 8
    fits int8 because x in [-32768, 32767]. Pure elementwise int ops —
    the (16,128)->(32,128) retile this implies measured 3.6x cheaper
    than the f32 dequant it replaces (DESIGN.md r5 postscript table).
    """
    lo = ((x_i16.astype(jnp.int32) + 128) & 0xFF) - 128
    hi = (x_i16.astype(jnp.int32) - lo) >> 8
    return hi.astype(jnp.int8), lo.astype(jnp.int8)


@lru_cache(maxsize=None)
def _i16_kernel_consts(cfg: StftConfig, rb: bytes, tier: str) -> dict:
    """Blocked-stream consts plus the design-time integer kernel limbs.

    Quantizes the SAME norm-folded runtime kernel the f32 blocked paths
    consume (streaming_pipeline._blocked_stream_consts), so the integer
    tier inherits the fold/divide-after handling unchanged.
    """
    c = _blocked_stream_consts(cfg, rb)
    kern = np.asarray(c["kern"], np.float64)  # [mg*gh, gh]
    kmax = float(np.max(np.abs(kern)))
    if kmax == 0.0:
        kmax = 1.0
    out = dict(c)
    # NOTE: cache numpy (not jnp) arrays — this is called inside jit traces
    # and a cached device array created under one trace leaks into the next.
    if tier == "int8x1":
        s1 = kmax / 127.0
        out["k_i8"] = np.clip(np.rint(kern / s1), -127, 127).astype(np.int8)
        out["k_scale"] = s1
    else:
        # Two-limb kernel: k ~= (k_hi*128 + k_lo) * s2, |k_hi|,|k_lo|<=127.
        s2 = kmax / 16256.0  # 127*128
        kq = np.clip(np.rint(kern / s2), -16256, 16256).astype(np.int32)
        k_hi_i = np.round(kq / 128.0).astype(np.int32)
        out["k_hi"] = k_hi_i.astype(np.int8)
        out["k_lo"] = (kq - k_hi_i * 128).astype(np.int8)
        out["k_scale"] = s2
    return out


def _i8_dot(a, b):
    return jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _hopblock_apply_i8(x_i8, kmat_i8, block, n_out, mg):
    """hopblock_apply's shifted-view accumulation on int8 operands,
    int32 accumulator (exact; headroom: |acc| <= 127*127*mg*block << 2^31
    for every supported geometry). Mirrors fft/matmul_backend.py
    hopblock_apply's indexing verbatim so the integer tier reads exactly
    the same context windows as the f32 formulation."""
    nb = -(-n_out // block)
    left = 0
    right = (nb - 1 + mg) * block - left - x_i8.shape[-1]
    x_ext = jnp.pad(x_i8, ((0, 0),) * (x_i8.ndim - 1) + ((left, right),))
    blocks = x_ext.reshape(x_ext.shape[:-1] + (-1, block))
    acc = None
    for m in range(mg):
        term = _i8_dot(
            blocks[..., m : m + nb, :],
            kmat_i8[m * block : (m + 1) * block, :],
        )
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (nb * block,))[..., :n_out]


@partial(
    jax.jit,
    static_argnames=("cfg", "rb", "tier", "head", "tail", "emit_i16"),
)
def _i16_blocked_chunk(
    lctx_i16, mid_i16, rctx_i16, cfg: StftConfig, rb: bytes, tier: str,
    head: bool, tail: bool, emit_i16: bool,
):
    """One halo-extended blocked chunk on int16 wire samples.

    Interior: int8-limb hop-block Toeplitz dots (int32 accumulation,
    combined in f32 once per chunk). Head/tail edge patches: the f32
    `blocked_edge_patch` on the dequantized patch region (span_p samples
    — the only dequant in the program). Structure mirrors
    streaming_pipeline._blocked_chunk.
    """
    from .fft import dispatch as _fft
    from .fft.matmul_backend import blocked_edge_patch, blocked_patch_span

    c = _i16_kernel_consts(cfg, rb, tier)
    n, hop = cfg.frame_size, cfg.hop_size
    edge, gh = c["edge"], c["gh"]
    mg = c["kern"].shape[0] // gh
    prec = _fft.to_lax_precision(cfg.fft_precision)
    s = mid_i16.shape[-1]
    x_ext_i16 = jnp.concatenate([lctx_i16, mid_i16, rctx_i16], axis=-1)
    hi, lo = i16_limbs(x_ext_i16)
    if tier == "int8x1":
        k_i8 = jnp.asarray(c["k_i8"])
        acc_h = _hopblock_apply_i8(hi, k_i8, gh, s, mg)
        acc_l = _hopblock_apply_i8(lo, k_i8, gh, s, mg)
        out = (
            acc_h.astype(jnp.float32) * jnp.float32(256.0)
            + acc_l.astype(jnp.float32)
        ) * jnp.float32(c["k_scale"] / _I16_SCALE)
    else:
        k_hi, k_lo = jnp.asarray(c["k_hi"]), jnp.asarray(c["k_lo"])
        hh = _hopblock_apply_i8(hi, k_hi, gh, s, mg)
        lh = _hopblock_apply_i8(lo, k_hi, gh, s, mg)
        hl = _hopblock_apply_i8(hi, k_lo, gh, s, mg)
        ll = _hopblock_apply_i8(lo, k_lo, gh, s, mg)
        out = (
            hh.astype(jnp.float32) * jnp.float32(128.0 * 256.0)
            + lh.astype(jnp.float32) * jnp.float32(128.0)
            + hl.astype(jnp.float32) * jnp.float32(256.0)
            + ll.astype(jnp.float32)
        ) * jnp.float32(c["k_scale"] / _I16_SCALE)
    if c["interior_norm_tile"] is not None:
        out = out / jnp.tile(jnp.asarray(c["interior_norm_tile"]), s // hop)
    span_p = blocked_patch_span(n, hop)
    if head or tail:
        # Dequant ONLY the patch regions (f32 edge math shared with the
        # f32 streamer; tiny vs the chunk).
        x_f = x_ext_i16.astype(jnp.float32) * jnp.float32(1.0 / _I16_SCALE)
        if head:
            region = x_f[..., edge : edge + span_p]
            p = blocked_edge_patch(
                region, n, hop, c["wb"], c["sb"], rb, prec, "head"
            ) / jnp.asarray(c["head_norm"])
            out = jnp.concatenate([p, out[..., edge:]], axis=-1)
        if tail:
            region = x_f[..., edge + s - span_p : edge + s]
            p = blocked_edge_patch(
                region, n, hop, c["wb"], c["sb"], rb, prec, "tail"
            ) / jnp.asarray(c["tail_norm"])
            out = jnp.concatenate([out[..., : s - edge], p], axis=-1)
    if emit_i16:
        out = jnp.clip(
            jnp.rint(out * jnp.float32(_I16_SCALE)), -32768.0, 32767.0
        ).astype(jnp.int16)
    return out


class I16BlockedStreamer:
    """Resumable chunk streamer for born-int16 wire audio on the blocked
    formulation's integer tier.

    Same protocol as `streaming_pipeline.BlockedChunkStreamer`: feed
    equal-shape G*hop-aligned int16 [..., S] chunks with `feed()` (returns
    the reconstructed PREDECESSOR chunk — one chunk of latency), drain the
    last with `finish()`; `state()`/`load_state()` checkpoint and resume
    bit-identically. With `emit_i16=True` (default) output chunks are
    int16 wire samples, closing the ingest->egress loop without any f32
    host traffic.
    """

    def __init__(
        self,
        cfg: StftConfig,
        spectral_fn=None,
        tier: str = "int8x2",
        emit_i16: bool = True,
    ) -> None:
        if tier not in _TIERS:
            raise ValueError(f"tier must be one of {_TIERS}, got {tier!r}")
        if cfg.center:
            raise ValueError("blocked streaming is uncentered (center=False)")
        rb = _resolve_blocked_per_bin(cfg, spectral_fn)
        if rb is None or not blocked_stream_supported(cfg, None, spectral_fn):
            raise ValueError(
                "config not supported by the blocked streamer (see "
                "blocked_stream_supported); the integer wire tier has no "
                "scan fallback"
            )
        self.cfg = cfg
        self.tier = tier
        self.emit_i16 = emit_i16
        self._rb = rb
        c = _blocked_stream_consts(cfg, rb)
        self._edge, self._rctx_n = c["edge"], c["right_ctx"]
        self._gh = c["gh"]
        self._prev = None
        self._lctx = None
        self._first = True
        self._finished = False
        self._s = None

    def _check(self, chunk):
        if chunk.dtype != jnp.int16:
            raise TypeError(f"wire chunks must be int16, got {chunk.dtype}")
        s = chunk.shape[-1]
        if self._s is None:
            n = self.cfg.frame_size
            if s % self._gh != 0 or s < 2 * self._edge + n:
                raise ValueError(
                    f"chunk length {s} must be a multiple of G*hop "
                    f"({self._gh}) and >= 2*(N-hop) + N "
                    f"({2 * self._edge + n})"
                )
            self._s = s
        elif s != self._s:
            raise ValueError(f"chunk length changed: {s} != {self._s}")

    def feed(self, chunk, force: bool = True):
        """Feed one int16 [..., S] chunk; returns the reconstructed
        PREDECESSOR chunk (None on the first call). `force=False` returns
        the un-forced device array (async-dispatch prefetch hook, same as
        BlockedChunkStreamer.feed)."""
        if self._finished:
            raise RuntimeError(
                "feed() after finish(): create a new I16BlockedStreamer "
                "(or load_state a checkpoint) to continue"
            )
        chunk = jnp.asarray(chunk)
        self._check(chunk)
        out = None
        if self._prev is not None:
            out = _i16_blocked_chunk(
                self._lctx, self._prev, chunk[..., : self._rctx_n],
                self.cfg, self._rb, self.tier, self._first, False,
                self.emit_i16,
            )
            self._first = False
            if force:
                out = np.asarray(out)
            self._lctx = self._prev[..., -self._edge :]
        else:
            self._lctx = jnp.zeros(
                chunk.shape[:-1] + (self._edge,), jnp.int16
            )
        self._prev = chunk
        return out

    def finish(self, force: bool = True):
        """Drain the final buffered chunk (ends the stream)."""
        self._finished = True
        if self._prev is None:
            return None
        rctx = jnp.zeros(self._prev.shape[:-1] + (self._rctx_n,), jnp.int16)
        out = _i16_blocked_chunk(
            self._lctx, self._prev, rctx, self.cfg, self._rb, self.tier,
            self._first, True, self.emit_i16,
        )
        self._first = False
        self._lctx = self._prev[..., -self._edge :]
        self._prev = None
        if force:
            out = np.asarray(out)
        return out

    def state(self) -> dict:
        return {
            "prev": None if self._prev is None else np.asarray(self._prev),
            "lctx": None if self._lctx is None else np.asarray(self._lctx),
            "first": self._first,
            "s": self._s,
        }

    def load_state(self, st: dict) -> None:
        self._finished = False
        self._prev = (
            None if st["prev"] is None else jnp.asarray(st["prev"])
        )
        self._lctx = (
            None if st["lctx"] is None else jnp.asarray(st["lctx"])
        )
        self._first = bool(st["first"])
        self._s = None if st["s"] is None else int(st["s"])


def i16_round_trip(
    x_i16: np.ndarray,
    cfg: StftConfig,
    spectral_fn=None,
    tier: str = "int8x2",
    chunk_samples: Optional[int] = None,
    emit_i16: bool = True,
) -> np.ndarray:
    """One-shot convenience: stream an int16 signal through
    I16BlockedStreamer in `chunk_samples` chunks (default: one chunk
    covering the padded signal) and concatenate the output.

    The integer interior makes the result bit-identical for EVERY valid
    chunk size (int32 accumulation is exact) — asserted in
    tests/test_wire_i16.py.
    """
    x_i16 = np.asarray(x_i16)
    total = x_i16.shape[-1]
    st = I16BlockedStreamer(cfg, spectral_fn, tier, emit_i16)
    gh = st._gh
    min_s = 2 * st._edge + cfg.frame_size
    if chunk_samples is None:
        chunk_samples = max(-(-total // gh) * gh, -(-min_s // gh) * gh)
    pad = -(total % chunk_samples) % chunk_samples
    xp = np.pad(x_i16, ((0, 0),) * (x_i16.ndim - 1) + ((0, pad),))
    outs = []
    for k in range(xp.shape[-1] // chunk_samples):
        o = st.feed(xp[..., k * chunk_samples : (k + 1) * chunk_samples])
        if o is not None:
            outs.append(o)
    outs.append(st.finish())
    return np.concatenate(outs, axis=-1)[..., :total]
