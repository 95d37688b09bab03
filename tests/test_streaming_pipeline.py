"""Scan-based streaming pipeline vs offline pipeline equivalence."""

import numpy as np
import pytest

from crlot_tpu.core.types import StftConfig
from crlot_tpu.metrics import snr_db
from crlot_tpu.pipeline import round_trip
from crlot_tpu.streaming_pipeline import streaming_round_trip


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, n).astype(np.float32)


@pytest.mark.parametrize("n,hop,bf", [(256, 64, 16), (1024, 256, 8), (256, 128, 32)])
def test_streaming_matches_offline_interior(n, hop, bf):
    cfg = StftConfig(frame_size=n, hop_size=hop, center=False)
    x = _sig(hop * bf * 6 + n)
    got, valid_from = streaming_round_trip(x, cfg, block_frames=bf)
    want = np.asarray(round_trip(x, cfg))
    lo, hi = max(valid_from, n), len(got) - n
    assert snr_db(want[lo:hi], got[lo:hi]) > 120.0
    # reconstruction quality vs the original signal too
    assert snr_db(x[lo:hi], got[lo:hi]) > 80.0


def test_streaming_block_boundaries_bitexact():
    # The carry hand-off must not depend on block size: two block sizes give
    # bit-identical streams (same frame set, same summation order).
    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    x = _sig(64 * 96 + 256, seed=1)
    a, _ = streaming_round_trip(x, cfg, block_frames=8)
    b, _ = streaming_round_trip(x, cfg, block_frames=32)
    m = min(len(a), len(b))
    np.testing.assert_array_equal(a[:m], b[:m])


def test_streaming_too_short_raises():
    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    with pytest.raises(ValueError):
        streaming_round_trip(_sig(100), cfg, block_frames=8)


def test_streaming_center_rejected():
    cfg = StftConfig(frame_size=256, hop_size=64, center=True)
    with pytest.raises(ValueError):
        streaming_round_trip(_sig(10000), cfg)


def test_streaming_matmul_backend_packed_path():
    """Forcing the MATMUL backend exercises the packed tiled round-trip
    inside the scan on CPU; output must match the XLA
    route within the matmul-DFT tolerance and keep block-size invariance."""
    from crlot_tpu.core.types import FftBackend, FftPrecision

    cfg = StftConfig(
        frame_size=512, hop_size=128, center=False,
        fft_backend=FftBackend.MATMUL, fft_precision=FftPrecision.HIGHEST,
    )
    cfg_xla = StftConfig(frame_size=512, hop_size=128, center=False)
    x = _sig(128 * 128 + 512, seed=2)
    a, v = streaming_round_trip(x, cfg, block_frames=16)
    b, _ = streaming_round_trip(x, cfg_xla, block_frames=16)
    m = min(len(a), len(b))
    np.testing.assert_allclose(a[v:m], b[v:m], atol=1e-4)
    c, _ = streaming_round_trip(x, cfg, block_frames=64)
    m = min(len(a), len(c))
    # CPU GEMM reduction order can vary with the batch (M) dimension, so
    # block-size invariance is ULP-tight here, not bit-exact (the XLA-FFT
    # route, transformed row-wise, stays bit-exact — tested above).
    np.testing.assert_allclose(a[:m], c[:m], atol=2e-6)


def test_streaming_spectral_fn_matches_offline():
    """Streaming with a spectral fn equals offline round_trip with the same
    fn on the interior — across all three lowerings: composed (fixed EQ on
    MATMUL), packed (noise gate on MATMUL), complex (XLA route)."""
    import crlot_tpu.spectral as S
    from crlot_tpu.core.types import FftBackend, FftPrecision

    n, hop, bf = 512, 128, 16
    x = _sig(hop * bf * 6 + n, seed=3)
    cfg_mm = StftConfig(
        frame_size=n, hop_size=hop, center=False,
        fft_backend=FftBackend.MATMUL, fft_precision=FftPrecision.HIGHEST,
    )
    cfg_xla = StftConfig(frame_size=n, hop_size=hop, center=False)
    eq = S.band_gain([4000.0, 12000.0], [1.0, 0.4, 0.1], 48000, n)
    gate = S.noise_gate(-40.0)
    for cfg, fn in [
        (cfg_mm, eq),      # composed one-matmul path
        (cfg_mm, gate),    # packed Re/Im path
        (cfg_xla, eq),     # complex XLA route
        (cfg_xla, lambda s: s * 0.5),  # plain fn, complex route
    ]:
        got, valid_from = streaming_round_trip(
            x, cfg, block_frames=bf, spectral_fn=fn
        )
        want = np.asarray(round_trip(x, cfg, spectral_fn=fn))
        lo, hi = max(valid_from, n), len(got) - n
        assert snr_db(want[lo:hi], got[lo:hi]) > 90.0, (cfg.fft_backend, fn)


def test_process_wav_file_matches_unbroken_stream(tmp_path):
    """File-to-file chunked processing equals one unbroken streaming run
    bit-for-bit before the 16-bit quantization, and survives WAV round-trip
    at the codec's precision; stereo + EQ + zero-padded tail covered."""
    import crlot_tpu as ct
    from crlot_tpu import spectral as S
    from crlot_tpu.streaming_pipeline import process_wav_file

    rng = np.random.default_rng(9)
    sr = 48000
    total = 50321  # deliberately NOT chunk-aligned (exercises EOF padding)
    x = rng.uniform(-0.8, 0.8, (2, total)).astype(np.float32)
    infile = str(tmp_path / "in.wav")
    outfile = str(tmp_path / "out.wav")
    ct.write_wav(infile, x, sr, bits=32, float_format=True)

    cfg = StftConfig(frame_size=512, hop_size=128, center=False)
    eq = S.band_gain([4000.0], [1.0, 0.5], sr, 512)
    n_written = process_wav_file(
        infile, outfile, cfg, spectral_fn=eq,
        block_frames=16, blocks_per_chunk=4, bits=32,
    )
    assert n_written == total
    y, _ = ct.read_wav(outfile)
    assert y.shape == (2, total)

    # reference: unbroken single-call stream per channel over the same
    # frame set (zero-pad past EOF like the chunked path does)
    n, hop = 512, 128
    chunk = 16 * 4 * hop
    span_frames = -(-total // chunk) * (chunk // hop)
    need = (span_frames - 1) * hop + n
    xp = np.pad(x, [(0, 0), (0, need - total)])
    for c in range(2):
        want, _ = __import__("crlot_tpu").streaming_round_trip(
            xp[c], cfg, block_frames=16, spectral_fn=eq
        )
        np.testing.assert_allclose(
            y[c], want[:total], atol=2e-6,
        )


def test_int16_wire_path_within_one_lsb():
    """The int16-wire streaming path (dequantize in-jit -> round-trip ->
    requantize, bench/suite.py's sustained loop) must match the f32 path
    run on the SAME dequantized input to within one output LSB — the only
    difference is the final quantization step (verdict r3 item 2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.frame.framing import hop_block_frames
    from crlot_tpu.streaming_pipeline import streaming_round_trip_blocks

    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    n, hop = 256, 64
    block_frames, blocks = 8, 4
    chunk_frames = block_frames * blocks
    span = chunk_frames * hop + (n - hop)
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.9, 0.9, span).astype(np.float32)
    x_i16 = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
    tail0 = jnp.zeros(n - hop, jnp.float32)

    @jax.jit
    def f32_path(seg):
        frames = hop_block_frames(seg, n, hop, chunk_frames)
        frames = frames.reshape(blocks, block_frames, n)
        y, _ = streaming_round_trip_blocks(
            frames, cfg, block_frames, None, carry_tail=tail0,
            return_carry=True,
        )
        return y

    @jax.jit
    def i16_path(seg_i16):
        xf = seg_i16.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
        y = f32_path(xf)
        return jnp.clip(
            jnp.round(y * 32768.0), -32768.0, 32767.0
        ).astype(jnp.int16)

    dequant = x_i16.astype(np.float32) / 32768.0
    y_f32 = np.asarray(f32_path(jnp.asarray(dequant)))
    y_i16 = np.asarray(i16_path(jnp.asarray(x_i16)))
    delta_lsb = np.max(
        np.abs(y_i16.astype(np.float32) / 32768.0 - y_f32)
    ) * 32768.0
    assert delta_lsb <= 1.0, f"int16 wire path off by {delta_lsb:.2f} LSB"


def test_scan_over_chunks_matches_chunked_dispatch():
    """The suite's one-program device-resident formulation (lax.scan over
    chunks, bench/suite.py stream_sustained_device_resident_scan_*) must be
    bit-identical to dispatching the same chunk program once per chunk with
    a host-carried tail — same chunk boundaries, same OLA accumulation
    order, so the outputs may not differ by even 1 ULP."""
    import jax
    import jax.numpy as jnp

    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.frame.framing import hop_block_frames
    from crlot_tpu.streaming_pipeline import streaming_round_trip_blocks

    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    n, hop = 256, 64
    block_frames, blocks_per_chunk, n_chunks = 8, 4, 5
    chunk_frames = block_frames * blocks_per_chunk
    chunk_samples = chunk_frames * hop
    span = chunk_samples + (n - hop)
    x = _sig(n_chunks * chunk_samples + (n - hop), seed=11)

    def chunk(seg, tail):
        frames = hop_block_frames(seg, n, hop, chunk_frames)
        frames = frames.reshape(blocks_per_chunk, block_frames, n)
        return streaming_round_trip_blocks(
            frames, cfg, block_frames, None, carry_tail=tail,
            return_carry=True,
        )

    segs = np.stack(
        [x[k * chunk_samples : k * chunk_samples + span]
         for k in range(n_chunks)]
    )

    dispatch = jax.jit(chunk)
    tail = jnp.zeros(n - hop, jnp.float32)
    outs = []
    for k in range(n_chunks):
        y, tail = dispatch(jnp.asarray(segs[k]), tail)
        outs.append(np.asarray(y))

    @jax.jit
    def scan_program(segs2, tail0):
        def step_fn(tail_c, seg):
            y, tail2 = chunk(seg, tail_c)
            return tail2, y

        return jax.lax.scan(step_fn, tail0, segs2)

    _, ys = scan_program(
        jnp.asarray(segs), jnp.zeros(n - hop, jnp.float32)
    )
    np.testing.assert_array_equal(np.asarray(ys), np.stack(outs))


# ---------------------------------------------------------------------------
# Blocked (hop-block Toeplitz) chunk streamer — r5 (closes the r4 verdict's
# 26x one-shot-vs-stream gap by routing the headline formulation into the
# streaming path).
# ---------------------------------------------------------------------------

import jax
import jax.numpy as jnp

from crlot_tpu.core.types import FftBackend
from crlot_tpu.pipeline import blocked_composed_round_trip
from crlot_tpu.streaming_pipeline import (
    BlockedChunkStreamer,
    blocked_stream_supported,
)


def _blocked_oneshot(x, cfg, fn=None):
    from crlot_tpu.spectral import resolve_per_bin_response

    pb = (
        np.ones(cfg.frame_size // 2 + 1)
        if fn is None
        else resolve_per_bin_response(fn, cfg.frame_size)
    )
    return np.asarray(
        jax.jit(lambda v: blocked_composed_round_trip(v, cfg, pb))(
            jnp.asarray(x)
        )
    )


def _stream(cfg, x, s, fn=None):
    st = BlockedChunkStreamer(cfg, fn)
    k = x.shape[-1] // s
    outs = [st.feed(x[:, i * s : (i + 1) * s]) for i in range(k)]
    outs.append(st.finish())
    return np.concatenate([o for o in outs if o is not None], axis=1)


def _csig(c, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (c, t)).astype(np.float32)


@pytest.mark.parametrize("n,hop,s,k", [
    (1024, 256, 8192, 4),   # headline config
    (1024, 256, 8192, 1),   # single-chunk stream (head+tail in one chunk)
    (512, 128, 4096, 3),
    (256, 64, 1280, 3),     # hop < 128
    (1024, 64, 4096, 3),
])
def test_blocked_streamer_identity_bitexact_vs_oneshot(n, hop, s, k):
    """Chunked blocked identity == blocked one-shot, BIT-exact: every chunk
    row is the one-shot's full-kernel-row dot over the same data (real
    halo context replaces the one-shot's interior view; zeros at the
    stream edges), and the stream head/tail run the one-shot's exact
    phantom-frame patch ops."""
    cfg = StftConfig(
        frame_size=n, hop_size=hop, center=False,
        fft_backend=FftBackend.MATMUL,
    )
    assert blocked_stream_supported(cfg, s)
    x = _csig(2, k * s, seed=n + hop)
    np.testing.assert_array_equal(
        _stream(cfg, x, s), _blocked_oneshot(x, cfg)
    )


def test_blocked_streamer_eq_response():
    """Fixed per-bin EQ: stream head/tail patches are BIT-exact vs the
    one-shot (mesh-independent op shapes); the interior matches within
    ~2 ULP on CPU, where the backend's within-row dot reduction order
    varies with the matmul batch size (chunk rows vs whole-stream rows —
    the documented CPU caveat; chip_smoke.py checks the GPU)."""
    import crlot_tpu.spectral as sp

    cfg = StftConfig(
        frame_size=1024, hop_size=256, center=False,
        fft_backend=FftBackend.MATMUL,
    )
    eq = sp.band_gain([3000.0], [1.0, 0.4], 48000, 1024)
    s, k = 8192, 3
    x = _csig(2, k * s, seed=7)
    y = _stream(cfg, x, s, eq)
    y1 = _blocked_oneshot(x, cfg, eq)
    edge = cfg.frame_size - cfg.hop_size
    np.testing.assert_array_equal(y[:, :edge], y1[:, :edge])
    np.testing.assert_array_equal(y[:, -edge:], y1[:, -edge:])
    np.testing.assert_allclose(y, y1, rtol=0, atol=2e-6)


def test_blocked_streamer_synthesis_window_nonfold():
    """synthesis_window mode fails the norm-fold gate (f32 interior wobbles
    ~1 ULP) exactly like the one-shot's own gate; the streamer's
    divide-after tile must reproduce the one-shot's divide-after values."""
    cfg = StftConfig(
        frame_size=512, hop_size=128, center=False,
        fft_backend=FftBackend.MATMUL, synthesis_window=True,
    )
    s, k = 4096, 3
    assert blocked_stream_supported(cfg, s)
    x = _csig(2, k * s, seed=9)
    y = _stream(cfg, x, s)
    y1 = _blocked_oneshot(x, cfg)
    edge = cfg.frame_size - cfg.hop_size
    np.testing.assert_array_equal(y[:, :edge], y1[:, :edge])
    np.testing.assert_array_equal(y[:, -edge:], y1[:, -edge:])
    np.testing.assert_allclose(y, y1, rtol=0, atol=2e-6)
    # and the reconstruction is actually good (interior: the first/last
    # edge samples divide near-zero w^2 coverage by eps — edge policy)
    assert snr_db(x[:, edge:-edge], y[:, edge:-edge]) > 60.0


def test_blocked_streamer_ckpt_resume_bitexact():
    """Mid-stream checkpoint through an npz round-trip resumes
    BIT-identically to the unbroken stream (same programs, same state)."""
    import tempfile

    cfg = StftConfig(
        frame_size=1024, hop_size=256, center=False,
        fft_backend=FftBackend.MATMUL,
    )
    s, k = 8192, 4
    x = _csig(2, k * s, seed=11)
    full = _stream(cfg, x, s)

    st = BlockedChunkStreamer(cfg)
    outs = [st.feed(x[:, i * s : (i + 1) * s]) for i in range(2)]
    state = st.state()
    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        np.savez(f.name, prev=state["prev"], lctx=state["lctx"],
                 first=state["first"], s=state["s"])
        with np.load(f.name) as z:
            restored = {
                "prev": z["prev"], "lctx": z["lctx"],
                "first": bool(z["first"]), "s": int(z["s"]),
            }
    st2 = BlockedChunkStreamer(cfg)
    st2.load_state(restored)
    outs += [st2.feed(x[:, i * s : (i + 1) * s]) for i in range(2, k)]
    outs.append(st2.finish())
    resumed = np.concatenate([o for o in outs if o is not None], axis=1)
    np.testing.assert_array_equal(resumed, full)


def test_blocked_streamer_validation():
    cfg = StftConfig(
        frame_size=1024, hop_size=256, center=False,
        fft_backend=FftBackend.MATMUL,
    )
    with pytest.raises(ValueError, match="center"):
        BlockedChunkStreamer(StftConfig(frame_size=1024, hop_size=256,
                                        center=True))
    st = BlockedChunkStreamer(cfg)
    with pytest.raises(ValueError, match="multiple of G\\*hop"):
        st.feed(np.zeros((1, 1000), np.float32))
    st.feed(np.zeros((1, 8192), np.float32))
    with pytest.raises(ValueError, match="changed"):
        st.feed(np.zeros((1, 4096), np.float32))
    st.finish()
    with pytest.raises(RuntimeError, match="finish"):
        st.feed(np.zeros((1, 8192), np.float32))
    # nonlinear spectral fns are not per-bin: unsupported
    assert not blocked_stream_supported(cfg, 8192, lambda spec: spec ** 2)


def test_blocked_group_for_gate():
    from crlot_tpu.fft.matmul_backend import (
        blocked_group_for,
        composed_block_supported,
    )

    assert blocked_group_for(1024, 256) == 2   # unchanged headline kernel
    assert blocked_group_for(1024, 512) == 2
    assert blocked_group_for(256, 64) == 2     # r5: hop < 128 now supported
    assert blocked_group_for(1024, 64) == 2
    assert composed_block_supported(256, 64)
    assert not composed_block_supported(1024, 192)   # hop does not divide N
    assert blocked_group_for(1000, 250) == 2         # any hop dividing N
    assert blocked_group_for(1024, 32) == 2
    assert not composed_block_supported(1024, 1024)  # no overlap (R < 2)
    assert not composed_block_supported(8192, 512)   # beyond MAX_MATMUL_NFFT
