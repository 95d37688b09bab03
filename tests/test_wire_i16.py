"""Born-int16 wire ingest tier (crlot_tpu/wire.py).

Gates the production wiring of the r5 born-integer probe (DESIGN.md
"r5 postscript"): int8-limb blocked round-trips on int16 wire chunks.
Reference anchor: the reference streams int16 WAV wire data through its
e2e loop (/root/reference/bench/e2e_benchmark.cc:138-186) after a host
dequant; here the dequant never happens.
"""

import numpy as np
import pytest

from crlot_tpu import spectral as S
from crlot_tpu.core.types import FftBackend, StftConfig
from crlot_tpu.streaming_pipeline import BlockedChunkStreamer
from crlot_tpu.wire import I16BlockedStreamer, i16_round_trip

CFG = StftConfig(
    frame_size=1024, hop_size=256, center=False,
    fft_backend=FftBackend.MATMUL,
)


def _wire_signal(total, seed=0, channels=None):
    rng = np.random.default_rng(seed)
    shape = (total,) if channels is None else (channels, total)
    x_f = rng.uniform(-0.9, 0.9, shape)
    x_i16 = np.clip(np.rint(x_f * 32768.0), -32768, 32767).astype(np.int16)
    return x_f, x_i16


def _snr_db(ref, got):
    err = got.astype(np.float64) - ref.astype(np.float64)
    return 10 * np.log10(
        np.sum(ref.astype(np.float64) ** 2)
        / max(float(np.sum(err**2)), 1e-300)
    )


@pytest.mark.parametrize("tier", ["int8x2", "int8x1"])
def test_identity_interior_snr(tier):
    """Identity round-trip on wire samples: the int16 quantization noise
    floor (~98 dB) dominates both tiers."""
    x_f, x_i16 = _wire_signal(48000)
    y = i16_round_trip(x_i16, CFG, tier=tier, emit_i16=False)
    edge = CFG.frame_size - CFG.hop_size
    snr = _snr_db(x_f[edge:-edge], y[edge:-edge])
    assert snr >= 90.0, snr


def test_chunk_size_invariance_bitexact():
    """int32 interior accumulation is exact => output is bit-identical
    for every valid chunk size (stronger than the f32 streamer's
    CPU-backend 2-ULP caveat)."""
    _, x_i16 = _wire_signal(48000)
    ya = i16_round_trip(x_i16, CFG, chunk_samples=4096)
    yb = i16_round_trip(x_i16, CFG, chunk_samples=8192)
    yo = i16_round_trip(x_i16, CFG)  # single chunk
    assert ya.dtype == np.int16
    assert np.array_equal(ya, yb)
    assert np.array_equal(ya, yo)


def test_matches_f32_blocked_streamer():
    """int8x2 vs the f32 BlockedChunkStreamer on the dequantized signal:
    kernel quantization sits ~90 dB below kmax, so the integer tier tracks
    the f32 path well past the 60 dB quality gate."""
    _, x_i16 = _wire_signal(40960)
    x_deq = (x_i16.astype(np.float32) / 32768.0).astype(np.float32)
    s = 8192
    st_f = BlockedChunkStreamer(CFG)
    outs = []
    for k in range(x_deq.shape[-1] // s):
        o = st_f.feed(x_deq[k * s : (k + 1) * s])
        if o is not None:
            outs.append(o)
    outs.append(st_f.finish())
    y_f32 = np.concatenate(outs, axis=-1)
    y_i = i16_round_trip(x_i16, CFG, chunk_samples=s, emit_i16=False)
    snr = _snr_db(y_f32, y_i)
    assert snr >= 85.0, snr


def test_eq_per_bin_response():
    """Fixed per-bin EQ rides the same blocked kernel; int8x2 (the
    accuracy-conservative tier for flattened kernel rows) tracks the f32
    EQ stream past the 60 dB gate."""
    eq = S.band_gain([4000.0, 12000.0], [1.0, 0.4, 0.1], 48000, 1024)
    _, x_i16 = _wire_signal(40960, seed=3)
    x_deq = (x_i16.astype(np.float32) / 32768.0).astype(np.float32)
    s = 8192
    st_f = BlockedChunkStreamer(CFG, spectral_fn=eq)
    outs = []
    for k in range(x_deq.shape[-1] // s):
        o = st_f.feed(x_deq[k * s : (k + 1) * s])
        if o is not None:
            outs.append(o)
    outs.append(st_f.finish())
    y_f32 = np.concatenate(outs, axis=-1)
    y_i = i16_round_trip(
        x_i16, CFG, spectral_fn=eq, chunk_samples=s, emit_i16=False
    )
    snr = _snr_db(y_f32, y_i)
    assert snr >= 60.0, snr


def test_resume_bitexact():
    """state()/load_state() across a simulated restart: resumed stream
    emits bit-identical chunks."""
    _, x_i16 = _wire_signal(49152, seed=5)
    s = 8192
    chunks = [x_i16[k * s : (k + 1) * s] for k in range(6)]
    st = I16BlockedStreamer(CFG)
    full = [st.feed(c) for c in chunks] + [st.finish()]

    st1 = I16BlockedStreamer(CFG)
    for c in chunks[:3]:
        st1.feed(c)
    ck = st1.state()
    st2 = I16BlockedStreamer(CFG)
    st2.load_state(ck)
    resumed = [st2.feed(c) for c in chunks[3:]] + [st2.finish()]
    want = full[3:]
    assert len(resumed) == len(want)
    for a, b in zip(resumed, want):
        assert np.array_equal(a, b)


def test_multichannel_and_i16_egress_dtype():
    """[C, S] wire chunks stream per-channel; int16 egress (default)
    keeps identity SNR above 90 dB end to end."""
    x_f, x_i16 = _wire_signal(24576, seed=7, channels=3)
    y = i16_round_trip(x_i16, CFG, chunk_samples=8192)
    assert y.dtype == np.int16 and y.shape == x_i16.shape
    edge = CFG.frame_size - CFG.hop_size
    snr = _snr_db(
        x_f[:, edge:-edge], y[:, edge:-edge].astype(np.float64) / 32768.0
    )
    assert snr >= 90.0, snr


def test_rejects_bad_inputs():
    st = I16BlockedStreamer(CFG)
    with pytest.raises(TypeError):
        st.feed(np.zeros(8192, np.float32))
    with pytest.raises(ValueError):
        st.feed(np.zeros(1000, np.int16))  # not G*hop aligned
    with pytest.raises(ValueError):
        I16BlockedStreamer(CFG, tier="int4")
    with pytest.raises(ValueError):
        I16BlockedStreamer(
            StftConfig(frame_size=1024, hop_size=256, center=True)
        )
