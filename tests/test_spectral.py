"""Spectral processing ops through the full pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from crlot_tpu import spectral as S
from crlot_tpu.core.types import StftConfig
from crlot_tpu.metrics import snr_db
from crlot_tpu.pipeline import round_trip, stft


def _sig(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, n).astype(np.float32)


CFG = StftConfig(frame_size=1024, hop_size=256, center=True)


def test_gain_through_pipeline():
    x = _sig(48000)
    y = np.asarray(round_trip(x, CFG, spectral_fn=S.gain(0.25)))
    assert snr_db(x * 0.25, y) > 60


def test_fir_filter_through_pipeline():
    # A lowpass FIR applied in the spectral domain must match time-domain
    # convolution of the signal (interior, away from edges).
    from scipy import signal as sps

    taps = sps.firwin(63, 0.25)
    x = _sig(48000, seed=1)
    h = S.fir_frequency_response(taps, 1024)
    y = np.asarray(round_trip(x, CFG, spectral_fn=S.per_bin_filter(h)))
    want = sps.lfilter(taps, [1.0], x.astype(np.float64))
    # The spectral multiply carries the filter's own causal delay, so y and
    # lfilter output align sample-for-sample.
    lo, hi = 2048, len(x) - 2048
    assert snr_db(want[lo:hi], y[lo:hi]) > 40


def test_noise_gate_silences_noise_floor():
    rng = np.random.default_rng(2)
    t = np.arange(48000) / 48000
    clean = 0.5 * np.sin(2 * np.pi * 440 * t)
    noise = 1e-4 * rng.standard_normal(48000)
    x = (clean + noise).astype(np.float32)
    gate = S.noise_gate(threshold_db=-40.0, attenuation_db=-120.0)
    y = np.asarray(round_trip(x, CFG, spectral_fn=gate))
    # The tone survives; broadband noise floor drops
    assert snr_db(clean[2048:-2048], y[2048:-2048]) > snr_db(
        clean[2048:-2048], x[2048:-2048]
    )


def test_band_gain_eq():
    sr = 48000
    x = (
        0.5 * np.sin(2 * np.pi * 500 * np.arange(sr) / sr)
        + 0.5 * np.sin(2 * np.pi * 8000 * np.arange(sr) / sr)
    ).astype(np.float32)
    eq = S.band_gain([2000.0], [1.0, 0.0], sr, 1024)  # kill > 2 kHz
    y = np.asarray(round_trip(x, CFG, spectral_fn=eq))
    want = (0.5 * np.sin(2 * np.pi * 500 * np.arange(sr) / sr)).astype(np.float32)
    assert snr_db(want[2048:-2048], y[2048:-2048]) > 25


def test_spectral_subtraction_shapes():
    x = _sig(16384, seed=3)
    spec = stft(x, CFG)
    noise_mag = np.abs(np.asarray(spec)).mean(axis=0)
    f = S.spectral_subtraction(noise_mag, alpha=1.0, floor=0.05)
    out = np.asarray(f(spec))
    assert out.shape == spec.shape
    assert np.isfinite(out).all()


def test_power_db_floor():
    spec = np.zeros((2, 513), dtype=np.complex64)
    db = np.asarray(S.power_db(spec))
    assert np.all(db == -120.0)


def test_compose():
    f = S.compose(S.gain(2.0), S.gain(0.5))
    x = _sig(16384, seed=4)
    spec = stft(x, CFG)
    np.testing.assert_allclose(
        np.asarray(f(spec)), np.asarray(spec), rtol=1e-6
    )


def test_band_gain_validation():
    with pytest.raises(ValueError):
        S.band_gain([100.0], [1.0], 48000, 1024)


def test_per_bin_gains_protocol():
    """Real per-bin ops expose foldable gains; complex/nonlinear ones don't."""
    import crlot_tpu.spectral as sp
    from crlot_tpu.spectral import resolve_per_bin_gains

    n = 512
    k = n // 2 + 1
    g = resolve_per_bin_gains(sp.gain(0.5), n)
    assert g is not None and np.allclose(g, 0.5)
    bg = sp.band_gain([1000.0], [1.0, 0.25], 48000, n)
    g2 = resolve_per_bin_gains(bg, n)
    assert g2 is not None and g2.shape == (k,)
    assert resolve_per_bin_gains(bg, 2 * n) is None  # wrong nfft
    h = np.linspace(1.0, 0.0, k)
    assert resolve_per_bin_gains(sp.per_bin_filter(h), n) is not None
    hc = h.astype(np.complex64)
    assert resolve_per_bin_gains(sp.per_bin_filter(hc), n) is None
    assert resolve_per_bin_gains(sp.noise_gate(-40), n) is None  # nonlinear
    comp = sp.compose(sp.gain(2.0), sp.per_bin_filter(h))
    g3 = resolve_per_bin_gains(comp, n)
    assert g3 is not None and np.allclose(g3, 2.0 * h)
    comp2 = sp.compose(sp.gain(2.0), sp.noise_gate(-40))
    assert resolve_per_bin_gains(comp2, n) is None


@pytest.mark.parametrize("nfft", [256, 1024])
def test_folded_gains_match_complex_path(nfft):
    """Gains folded into the inverse constants == explicit complex-domain
    multiply, within the precision tier."""
    import jax

    import crlot_tpu.spectral as sp
    from crlot_tpu.core.types import WindowType
    from crlot_tpu.fft.matmul_backend import roundtrip_folded_tiled
    from crlot_tpu.window.windows import get_window

    rng = np.random.default_rng(11)
    f = 9
    x = jnp.asarray(rng.uniform(-1, 1, (f, nfft)).astype(np.float32))
    w64 = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    k = nfft // 2 + 1
    g = np.linspace(1.5, 0.1, k).astype(np.float64)
    got = np.asarray(
        roundtrip_folded_tiled(
            x, nfft, w64, None, jax.lax.Precision.HIGHEST,
            per_bin_gains_f64=g,
        )
    )
    spec = np.fft.rfft(np.asarray(x, np.float64) * w64, axis=-1) * g
    want = np.fft.irfft(spec, n=nfft, axis=-1)
    assert np.max(np.abs(got - want)) < 5e-6


def test_round_trip_spectral_fastpath_consistency():
    """round_trip with a foldable spectral_fn equals the complex route on
    CPU (where the packed path is disabled, proving both formulations)."""
    import crlot_tpu.spectral as sp
    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.pipeline import istft, round_trip, stft

    cfg = StftConfig(frame_size=512, hop_size=128, center=True)
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.uniform(-1, 1, 6000).astype(np.float32))
    fn = sp.band_gain([2000.0, 8000.0], [1.0, 0.5, 0.1], 48000, 512)
    via_rt = np.asarray(round_trip(x, cfg, spectral_fn=fn))
    via_spec = np.asarray(istft(fn(stft(x, cfg)), cfg, length=6000))
    assert np.max(np.abs(via_rt - via_spec)) < 5e-5


@pytest.mark.parametrize("nfft", [512, 999, 1000, 1024])
def test_composed_roundtrip_matches_oracle(nfft):
    """The one-matmul composed round-trip (diag(w).Bf.diag(g).Bi) matches
    the f64 rfft*g -> irfft oracle, including odd and non-pow2 N."""
    from crlot_tpu.fft.matmul_backend import roundtrip_composed_matmul
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    rng = np.random.default_rng(20)
    w = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    g = 10 ** rng.uniform(-1, 1, nfft // 2 + 1)
    fr = rng.uniform(-1, 1, (8, nfft)).astype(np.float32)
    got = np.asarray(roundtrip_composed_matmul(jnp.asarray(fr), nfft, w, g))
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * g
    want = np.fft.irfft(spec, n=nfft, axis=-1)
    assert snr_db(want, got) > 100


def test_composed_roundtrip_synthesis_window():
    from crlot_tpu.fft.matmul_backend import roundtrip_composed_matmul
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    nfft = 512
    rng = np.random.default_rng(21)
    w = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    g = 10 ** rng.uniform(-0.5, 0.5, nfft // 2 + 1)
    fr = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    got = np.asarray(
        roundtrip_composed_matmul(
            jnp.asarray(fr), nfft, w, g, synthesis_window_f64=w
        )
    )
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * g
    want = np.fft.irfft(spec, n=nfft, axis=-1) * w
    assert snr_db(want, got) > 100


def test_composed_matches_tiled_gained_path():
    """Composed one-matmul EQ and the tiled folded-gains formulation agree
    (both vs each other; they share no code past the f64 design)."""
    from crlot_tpu.fft.matmul_backend import (
        roundtrip_composed_matmul,
        roundtrip_folded_tiled,
    )
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    nfft = 1024
    rng = np.random.default_rng(22)
    w = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    g = 10 ** rng.uniform(-1, 1, nfft // 2 + 1)
    fr = rng.uniform(-1, 1, (8, nfft)).astype(np.float32)
    a = np.asarray(roundtrip_composed_matmul(jnp.asarray(fr), nfft, w, g))
    b = np.asarray(
        roundtrip_folded_tiled(
            jnp.asarray(fr), nfft, w, per_bin_gains_f64=g
        )
    )
    assert np.max(np.abs(a - b)) < 5e-5


def test_composed_complex_response_delay():
    """A complex response (pure delay exp(-i w d)) composes into the one-
    matmul round-trip: output = windowed frame circularly shifted by d."""
    from crlot_tpu.fft.matmul_backend import roundtrip_composed_matmul
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    nfft, d = 512, 37
    rng = np.random.default_rng(23)
    w = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    k = np.arange(nfft // 2 + 1)
    h = np.exp(-2j * np.pi * k * d / nfft)
    fr = rng.uniform(-1, 1, (8, nfft)).astype(np.float32)
    got = np.asarray(roundtrip_composed_matmul(jnp.asarray(fr), nfft, w, h))
    want = np.roll(fr.astype(np.float64) * w, d, axis=-1)
    assert snr_db(want, got) > 100


def test_composed_complex_response_matches_oracle():
    from crlot_tpu.fft.matmul_backend import roundtrip_composed_matmul
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    nfft = 1024
    rng = np.random.default_rng(24)
    w = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    h = (
        rng.standard_normal(nfft // 2 + 1)
        + 1j * rng.standard_normal(nfft // 2 + 1)
    )
    fr = rng.uniform(-1, 1, (8, nfft)).astype(np.float32)
    got = np.asarray(roundtrip_composed_matmul(jnp.asarray(fr), nfft, w, h))
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * h
    want = np.fft.irfft(spec, n=nfft, axis=-1)
    assert snr_db(want, got) > 95


def test_per_bin_response_protocol():
    from crlot_tpu.spectral import (
        resolve_per_bin_gains,
        resolve_per_bin_response,
    )

    n = 512
    k = n // 2 + 1
    hc = (np.ones(k) * np.exp(-1j * np.linspace(0, 3, k))).astype(complex)
    fc = S.per_bin_filter(hc)
    # complex responses do NOT qualify as real gains...
    assert resolve_per_bin_gains(fc, n) is None
    # ...but DO qualify as composable responses
    r = resolve_per_bin_response(fc, n)
    assert r is not None and r.dtype == np.complex128
    # real gains promote to responses
    r2 = resolve_per_bin_response(S.gain(0.5), n)
    assert r2 is not None and np.allclose(r2, 0.5)
    # compositions chain complex responses
    comp = S.compose(S.gain(2.0), S.per_bin_filter(hc))
    r3 = resolve_per_bin_response(comp, n)
    assert r3 is not None and np.allclose(r3, 2.0 * hc)
    # nonlinear fns do not qualify
    assert resolve_per_bin_response(S.noise_gate(-40), n) is None
    # wrong-nfft responses rejected
    assert resolve_per_bin_response(fc, 2 * n) is None


def test_round_trip_complex_response_consistency():
    """round_trip with a complex per-bin filter equals the explicit
    stft -> multiply -> istft route on CPU."""
    from crlot_tpu.pipeline import istft, round_trip, stft

    cfg = StftConfig(frame_size=512, hop_size=128, center=True)
    rng = np.random.default_rng(25)
    x = jnp.asarray(rng.uniform(-1, 1, 6000).astype(np.float32))
    k = np.arange(512 // 2 + 1)
    h = (0.8 * np.exp(-2j * np.pi * k * 5 / 512)).astype(np.complex64)
    fn = S.per_bin_filter(h)
    via_rt = np.asarray(round_trip(x, cfg, spectral_fn=fn))
    via_spec = np.asarray(istft(fn(stft(x, cfg)), cfg, length=6000))
    assert np.max(np.abs(via_rt - via_spec)) < 5e-5


def test_packed_protocol_matches_complex():
    """fn.packed(re, im) on split planes equals fn(re + i*im) for every op
    that advertises the packed protocol (the sharded and streaming matmul
    paths use it to skip complex64 interleave)."""
    rng = np.random.default_rng(26)
    K = 257
    nm = rng.uniform(0, 0.2, K).astype(np.float32)
    h = (rng.standard_normal(K) + 1j * rng.standard_normal(K)).astype(
        np.complex64
    )
    fns = [
        S.gain(0.3),
        S.band_gain([4000.0], [1.0, 0.25], 48000, 512),
        S.per_bin_filter(h),
        S.noise_gate(-40.0, attenuation_db=-80.0),
        S.spectral_subtraction(nm, alpha=1.2, floor=0.05),
        S.compose(S.gain(2.0), S.noise_gate(-35.0)),
    ]
    re = rng.uniform(-1, 1, (3, 8, K)).astype(np.float32)
    im = rng.uniform(-1, 1, (3, 8, K)).astype(np.float32)
    spec = jnp.asarray(re) + 1j * jnp.asarray(im)
    for fn in fns:
        assert hasattr(fn, "packed"), fn
        r2, i2 = fn.packed(jnp.asarray(re), jnp.asarray(im))
        want = np.asarray(fn(spec))
        np.testing.assert_allclose(np.asarray(r2), want.real, atol=2e-5)
        np.testing.assert_allclose(np.asarray(i2), want.imag, atol=2e-5)


def test_packed_tiled_route_matches_complex_route():
    """The full packed-plane round-trip formulation (tiled parts -> packed
    fn -> tiled inverse) equals stft -> fn -> istft frames on CPU."""
    from crlot_tpu.fft.matmul_backend import (
        irfft_folded_tiled_parts,
        rfft_folded_tiled_parts,
    )
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    nfft = 512
    hh = nfft // 2
    rng = np.random.default_rng(27)
    w = get_window(WindowType.HANN, nfft, True)
    fn = S.noise_gate(-40.0)
    fr = rng.uniform(-1, 1, (6, nfft)).astype(np.float32)
    re512, re_nyq, im_eff = rfft_folded_tiled_parts(
        jnp.asarray(fr), nfft, jnp.asarray(w)
    )
    re = jnp.concatenate([re512, re_nyq], axis=-1)
    zero = jnp.zeros_like(re_nyq)
    im = jnp.concatenate([zero, im_eff, zero], axis=-1)
    re, im = fn.packed(re, im)
    got = np.asarray(
        irfft_folded_tiled_parts(
            re[..., :hh], re[..., hh : hh + 1], im[..., 1:hh], nfft
        )
    )
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1)
    want = np.fft.irfft(np.asarray(fn(jnp.asarray(spec))), n=nfft, axis=-1)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_composed_conv_matches_matmul():
    """The strided-conv formulation of the composed round-trip (no frame
    matrix materialization) equals frame_signal + composed matmul."""
    from crlot_tpu.fft.matmul_backend import (
        roundtrip_composed_conv,
        roundtrip_composed_matmul,
    )
    from crlot_tpu.frame.framing import frame_signal
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    n, hop = 512, 128
    cfg = StftConfig(frame_size=n, hop_size=hop, center=False)
    rng = np.random.default_rng(30)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    k = np.arange(n // 2 + 1)
    g = (10 ** rng.uniform(-1, 1, n // 2 + 1)) * np.exp(
        -2j * np.pi * k * 2 / n
    )
    for shape in [(12000,), (3, 12000)]:
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        frames = frame_signal(jnp.asarray(x), cfg.frame_spec)
        a = np.asarray(roundtrip_composed_matmul(frames, n, w, g))
        b = np.asarray(
            roundtrip_composed_conv(
                jnp.asarray(x), n, hop, frames.shape[-2], w, g
            )
        )
        np.testing.assert_allclose(a, b, atol=2e-5)
