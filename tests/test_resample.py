"""Polyphase resampler tests (replaces r8brain; reference: main/main.cc:238-352).

Oracles: scipy.signal.resample_poly driven with OUR filter (exact algorithm
check) and analytic sine fidelity across the 44.1k->48k->16k chain
(BASELINE.json config 3).
"""

import numpy as np
import pytest
from scipy import signal as sps

from crlot_tpu.metrics import snr_db
from crlot_tpu.resample.polyphase import (
    design_lowpass,
    output_length,
    resample,
    resample_chunked,
)


def _sine(sr, seconds, freq, amp=0.7):
    t = np.arange(int(sr * seconds), dtype=np.float64) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 48000), (48000, 16000), (8000, 12000)])
def test_matches_scipy_resample_poly(sr_in, sr_out):
    import math

    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 4410).astype(np.float32)
    h = design_lowpass(l, m)  # same defaults as resample()
    # scipy multiplies a user-provided window by `up` internally; our design
    # already carries the gain-L compensation, so hand scipy h/L.
    want = sps.resample_poly(x.astype(np.float64), l, m, window=h / l)
    got = np.asarray(resample(x, sr_in, sr_out))
    assert got.shape == want.shape == (output_length(len(x), sr_in, sr_out),)
    assert snr_db(want, got) > 120.0  # same filter, same math, f32 vs f64


def test_sine_fidelity_44k_to_48k():
    x = _sine(44100, 1.0, 1000.0)
    y = np.asarray(resample(x, 44100, 48000))
    ideal = _sine(48000, len(y) / 48000, 1000.0)[: len(y)]
    edge = 4800
    assert snr_db(ideal[edge:-edge], y[edge:-edge]) > 100.0


def test_chain_44k_48k_16k():
    # BASELINE config: 44.1kHz -> 48kHz -> 16kHz chain
    x = _sine(44100, 1.0, 997.0)
    y48 = np.asarray(resample(x, 44100, 48000))
    y16 = np.asarray(resample(y48, 48000, 16000))
    ideal = _sine(16000, len(y16) / 16000, 997.0)[: len(y16)]
    edge = 1600
    assert snr_db(ideal[edge:-edge], y16[edge:-edge]) > 90.0


def test_stopband_rejection():
    # A tone above the target Nyquist must be attenuated by ~the design spec
    x = _sine(48000, 0.5, 11000.0)  # 11 kHz > 8 kHz Nyquist of 16 kHz out
    y = np.asarray(resample(x, 48000, 16000))
    edge = 1600
    core = y[edge:-edge]
    rms_out = np.sqrt(np.mean(core.astype(np.float64) ** 2))
    rms_in = 0.7 / np.sqrt(2)
    atten = 20 * np.log10(rms_in / max(rms_out, 1e-12))
    assert atten > 80.0, f"stopband attenuation {atten:.1f} dB"


def test_dc_preservation():
    x = np.full(10000, 0.5, dtype=np.float32)
    y = np.asarray(resample(x, 44100, 48000))
    core = y[2000:-2000]
    np.testing.assert_allclose(core, 0.5, atol=1e-4)


def test_multichannel():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (3, 4410)).astype(np.float32)
    y = np.asarray(resample(x, 44100, 48000))
    assert y.shape == (3, output_length(4410, 44100, 48000))
    for c in range(3):
        yc = np.asarray(resample(x[c], 44100, 48000))
        # batched vs single conv may pick different XLA algorithms: allow
        # float-level variance, not semantic difference
        np.testing.assert_allclose(y[c], yc, atol=2e-6)


def test_identity_rate():
    x = np.arange(100, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(resample(x, 48000, 48000)), x)


def test_chunked_matches_oneshot():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, 44100).astype(np.float32)
    want = np.asarray(resample(x, 44100, 48000))
    got = resample_chunked(x, 44100, 48000, chunk=8192)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_invalid():
    with pytest.raises(ValueError):
        resample(np.zeros(10, dtype=np.float32), 0, 48000)
    with pytest.raises(ValueError):
        resample(np.zeros((2, 3, 4), dtype=np.float32), 44100, 48000)


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 16000), (16000, 48000)])
def test_polyphase_multichannel_against_scipy(sr_in, sr_out):
    """Pure decimation (L=1) and pure interpolation (M=1) over 1 s of two
    channels: the grouped Toeplitz matmul against scipy's polyphase filter
    run with the same taps in float64."""
    import math

    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, sr_in)).astype(np.float32)
    h = design_lowpass(l, m)
    got = np.asarray(resample(x, sr_in, sr_out))
    assert got.shape == (2, output_length(sr_in, sr_in, sr_out))
    for c in range(2):
        want = sps.resample_poly(x[c].astype(np.float64), l, m, window=h / l)
        assert snr_db(want, got[c]) > 120.0


def test_resampled_stft_fused_matches_sequential():
    """The single-jit resample->frame->window->rFFT composition (BASELINE
    config 3 'fused with framing') equals running the two stages separately."""
    import jax.numpy as jnp

    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.pipeline import resampled_stft, stft

    rng = np.random.default_rng(11)
    x = rng.uniform(-0.9, 0.9, 44100).astype(np.float32)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    fused = np.asarray(resampled_stft(jnp.asarray(x), 44100, 48000, cfg))
    seq = np.asarray(stft(resample(jnp.asarray(x), 44100, 48000), cfg))
    assert fused.shape == seq.shape
    err = np.max(np.abs(fused - seq))
    scale = np.max(np.abs(seq))
    assert err <= 1e-5 * scale, f"fused vs sequential: {err} (scale {scale})"


def test_resampled_stft_output_rate_geometry():
    import jax.numpy as jnp

    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.pipeline import resampled_stft

    x = np.zeros(44100, np.float32)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    spec = resampled_stft(jnp.asarray(x), 44100, 48000, cfg)
    n_out = output_length(44100, 44100, 48000)
    assert spec.shape == (cfg.frame_spec.num_frames(n_out), 513)
