"""Matmul-DFT backend vs XLA FFT equivalence (tiered RMSE gates)."""

import jax.numpy as jnp
import numpy as np
import pytest

from crlot_tpu.core.types import WindowType

from crlot_tpu.fft.matmul_backend import irfft_matmul, rfft_matmul

SIZES = [256, 512, 1024, 2048,
         pytest.param(4096, marks=pytest.mark.slow)]


@pytest.mark.parametrize("nfft", SIZES)
def test_rfft_matches_xla(nfft):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    got = np.asarray(rfft_matmul(jnp.asarray(x), nfft))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(nfft)
    assert err < 1e-5, f"N={nfft}: rfft err {err}"


@pytest.mark.parametrize("nfft", SIZES)
def test_round_trip_rmse(nfft):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    y = np.asarray(irfft_matmul(rfft_matmul(jnp.asarray(x), nfft), nfft))
    rmse = np.sqrt(np.mean((x - y) ** 2))
    # Reference tiering: target 1e-6, hard gate 1e-5 (fft_test.cc:76-82).
    assert rmse < 1e-5, f"N={nfft}: rmse {rmse}"


def test_tone_bin():
    import jax.numpy as jnp

    nfft, k, amp = 1024, 7, 0.5
    t = np.arange(nfft)
    x = (amp * np.cos(2 * np.pi * k * t / nfft)).astype(np.float32)
    spec = np.asarray(rfft_matmul(jnp.asarray(x), nfft))
    assert abs(spec[k]) == pytest.approx(amp * nfft / 2, rel=1e-4)


def test_dispatch_auto_on_cpu_uses_xla():
    import jax.numpy as jnp

    from crlot_tpu.core.types import FftBackend
    from crlot_tpu.fft.dispatch import rfft

    x = jnp.ones((2, 512))
    a = np.asarray(rfft(x, 512, FftBackend.AUTO))
    b = np.asarray(jnp.fft.rfft(x, axis=-1))
    np.testing.assert_array_equal(a, b)  # a bare transform's AUTO is XLA


def test_dispatch_matmul_forced():
    import jax.numpy as jnp

    from crlot_tpu.core.types import FftBackend
    from crlot_tpu.fft.dispatch import irfft, rfft

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.uniform(-1, 1, (3, 1024)).astype(np.float32))
    y = np.asarray(
        irfft(rfft(x, 1024, FftBackend.MATMUL), 1024, FftBackend.MATMUL)
    )
    assert np.sqrt(np.mean((np.asarray(x) - y) ** 2)) < 1e-5


def test_pipeline_matmul_backend_snr():
    from crlot_tpu.core.types import FftBackend, StftConfig
    from crlot_tpu.metrics import snr_db
    from crlot_tpu.pipeline import round_trip

    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, 48000).astype(np.float32)
    cfg = StftConfig(
        frame_size=1024, hop_size=256, center=True,
        fft_backend=FftBackend.MATMUL,
    )
    y = np.asarray(round_trip(x, cfg))
    assert snr_db(x, y) > 90.0


def test_packed_roundtrip_matches_complex_path():
    import jax.numpy as jnp

    from crlot_tpu.fft.matmul_backend import (
        irfft_matmul,
        rfft_windowed_matmul,
        roundtrip_packed_matmul,
    )
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, (7, 1024)).astype(np.float32)
    w64 = get_window(WindowType.HANN, 1024, True, dtype=np.float64)
    via_complex = np.asarray(
        irfft_matmul(rfft_windowed_matmul(jnp.asarray(frames), 1024, w64), 1024)
    )
    packed = np.asarray(roundtrip_packed_matmul(jnp.asarray(frames), 1024, w64))
    # Identical matmuls, no complex interleave: bit-identical outputs.
    np.testing.assert_array_equal(packed, via_complex)


def test_packed_roundtrip_synthesis_window():
    import jax.numpy as jnp

    from crlot_tpu.fft.matmul_backend import roundtrip_packed_matmul
    from crlot_tpu.window.windows import get_window
    from crlot_tpu.core.types import WindowType

    rng = np.random.default_rng(6)
    frames = rng.uniform(-1, 1, (4, 512)).astype(np.float32)
    w64 = get_window(WindowType.HANN, 512, True, dtype=np.float64)
    got = np.asarray(
        roundtrip_packed_matmul(jnp.asarray(frames), 512, w64, w64)
    )
    want = np.fft.irfft(
        np.fft.rfft(frames.astype(np.float64) * w64, axis=-1), axis=-1
    ) * w64
    assert np.max(np.abs(got - want)) < 1e-4


FOLDED_SIZES = [2, 4, 8, 48, 256, 1000, 1024,
                pytest.param(4096, marks=pytest.mark.slow)]


@pytest.mark.parametrize("nfft", FOLDED_SIZES)
def test_folded_forward_matches_numpy(nfft):
    import jax.numpy as jnp

    from crlot_tpu.fft.matmul_backend import rfft_folded

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    got = np.asarray(rfft_folded(jnp.asarray(x), nfft))
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(nfft)
    assert err < 1e-5, f"N={nfft}: folded rfft err {err}"


@pytest.mark.parametrize("nfft", FOLDED_SIZES)
def test_folded_round_trip_rmse(nfft):
    import jax.numpy as jnp

    from crlot_tpu.fft.matmul_backend import irfft_folded, rfft_folded

    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    y = np.asarray(irfft_folded(rfft_folded(jnp.asarray(x), nfft), nfft))
    rmse = np.sqrt(np.mean((x - y) ** 2))
    assert rmse < 1e-5, f"N={nfft}: folded rmse {rmse}"


def test_folded_roundtrip_matches_packed():
    import jax.numpy as jnp

    from crlot_tpu.core.types import WindowType
    from crlot_tpu.fft.matmul_backend import (
        roundtrip_folded_matmul,
        roundtrip_packed_matmul,
    )
    from crlot_tpu.window.windows import get_window

    rng = np.random.default_rng(9)
    frames = rng.uniform(-1, 1, (7, 1024)).astype(np.float32)
    w64 = get_window(WindowType.HANN, 1024, True, dtype=np.float64)
    packed = np.asarray(roundtrip_packed_matmul(jnp.asarray(frames), 1024, w64))
    folded = np.asarray(roundtrip_folded_matmul(jnp.asarray(frames), 1024, w64))
    # Same transform through half-size bases: equal to f32 round-off.
    assert np.max(np.abs(folded - packed)) < 1e-5


def test_folded_roundtrip_synthesis_window():
    import jax.numpy as jnp

    from crlot_tpu.core.types import WindowType
    from crlot_tpu.fft.matmul_backend import roundtrip_folded_matmul
    from crlot_tpu.window.windows import get_window

    rng = np.random.default_rng(10)
    frames = rng.uniform(-1, 1, (4, 512)).astype(np.float32)
    w64 = get_window(WindowType.HANN, 512, True, dtype=np.float64)
    got = np.asarray(roundtrip_folded_matmul(jnp.asarray(frames), 512, w64, w64))
    want = np.fft.irfft(
        np.fft.rfft(frames.astype(np.float64) * w64, axis=-1), axis=-1
    ) * w64
    assert np.max(np.abs(got - want)) < 1e-4


def test_dispatch_matmul_uses_folded_for_even_sizes():
    import jax.numpy as jnp

    from crlot_tpu.core.types import FftBackend
    from crlot_tpu.fft.dispatch import irfft, rfft
    from crlot_tpu.fft.matmul_backend import irfft_folded, rfft_folded

    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(-1, 1, (3, 512)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(rfft(x, 512, FftBackend.MATMUL)),
        np.asarray(rfft_folded(x, 512)),
    )
    spec = rfft_folded(x, 512)
    np.testing.assert_array_equal(
        np.asarray(irfft(spec, 512, FftBackend.MATMUL)),
        np.asarray(irfft_folded(spec, 512)),
    )


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_tiled_roundtrip_matches_folded(nfft):
    """The lane-aligned tiled decomposition (512-core matmuls + rank-1
    borders, matmul_backend._tiled_consts) must match the plain folded path
    within f32 accumulation-order noise at every precision tier."""
    import jax

    from crlot_tpu.fft.matmul_backend import (
        roundtrip_folded_matmul,
        roundtrip_folded_tiled,
        tiled_supported,
    )
    from crlot_tpu.window.windows import get_window

    assert tiled_supported(nfft)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (17, nfft)).astype(np.float32))
    w64 = get_window(WindowType.HANN, nfft, True, dtype=np.float64)
    for prec in (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGH):
        t = np.asarray(roundtrip_folded_tiled(x, nfft, w64, None, prec))
        f = np.asarray(roundtrip_folded_matmul(x, nfft, w64, None, prec))
        tol = 2e-6 if prec == jax.lax.Precision.HIGHEST else 5e-5
        assert np.max(np.abs(t - f)) < tol


def test_tiled_parts_spectrum_matches_numpy():
    """Tiled packed layout (re512, nyquist, im_eff) reassembles to the
    numpy rfft of the windowed frame."""
    from crlot_tpu.fft.matmul_backend import rfft_folded_tiled_parts
    from crlot_tpu.window.windows import get_window

    nfft = 512
    h = nfft // 2
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (5, nfft)).astype(np.float32)
    w64 = get_window(WindowType.HAMMING, nfft, True, dtype=np.float64)
    re512, re_nyq, im_eff = rfft_folded_tiled_parts(
        jnp.asarray(x), nfft, jnp.asarray(w64.astype(np.float32))
    )
    want = np.fft.rfft(x.astype(np.float64) * w64, axis=-1)
    re = np.concatenate([np.asarray(re512), np.asarray(re_nyq)], axis=-1)
    assert np.max(np.abs(re - want.real)) < 1e-3  # HIGHEST default tier
    im = np.asarray(im_eff)
    assert np.max(np.abs(im - want.imag[:, 1:h])) < 1e-3
    # Im[0] and Im[Nyquist] are exactly zero for real input.
    assert np.max(np.abs(want.imag[:, 0])) < 1e-9
    assert np.max(np.abs(want.imag[:, h])) < 1e-9


def test_tiled_supported_predicate():
    from crlot_tpu.fft.matmul_backend import MAX_MATMUL_NFFT, tiled_supported

    assert tiled_supported(256)
    assert tiled_supported(1024)
    assert not tiled_supported(128)  # h = 64 not lane-aligned
    assert not tiled_supported(1000)
    assert not tiled_supported(2 * MAX_MATMUL_NFFT)


def _dot_algorithm(fn, *args):
    """The dot algorithm of the single dot_general in fn's jaxpr."""
    import jax

    eqns = [e for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns
            if e.primitive.name == "dot_general"]
    assert len(eqns) == 1, eqns
    return eqns[0].params["precision"]


@pytest.mark.parametrize("lhs_shape,want_x3", [
    ((1, 64), False), ((1, 1, 64), False), ((64,), False),
    ((2, 64), True), ((3, 1, 64), True),
])
def test_one_row_dot_never_runs_bf16x3(lhs_shape, want_x3):
    """A matrix-vector product at BF16_BF16_F32_X3 is a single bf16 pass on
    the GPU, so `_dot` hands one-row products F32_F32_F32 instead."""
    import jax

    from crlot_tpu.fft.matmul_backend import _dot

    x3 = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    f32 = jax.lax.DotAlgorithmPreset.F32_F32_F32
    got = _dot_algorithm(lambda a, b: _dot(a, b, x3),
                         jnp.ones(lhs_shape), jnp.ones((64, 32)))
    assert got == (x3 if want_x3 else f32), got


def test_gpu_tiers_map_to_explicit_algorithms(monkeypatch):
    """On a GPU each FftPrecision tier is one explicit dot algorithm (an
    unspecified f32 dot may run in TF32 there); elsewhere every tier is
    true f32."""
    import jax

    from crlot_tpu.core.types import FftPrecision
    from crlot_tpu.fft import dispatch

    presets = jax.lax.DotAlgorithmPreset
    assert dispatch.to_lax_precision(FftPrecision.HIGH) == presets.F32_F32_F32
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert (dispatch.to_lax_precision(FftPrecision.HIGH)
            == presets.BF16_BF16_F32_X3)
    assert dispatch.to_lax_precision(FftPrecision.HIGHEST) == presets.F32_F32_F32
    assert dispatch.to_lax_precision(None) is None


def test_gpu_high_tier_runs_the_blocked_kernel_on_cpu():
    """The GPU's HIGH algorithm (BF16_BF16_F32_X3) on the blocked route's
    own dot shape, run here: it compiles for a dot of many rows and stays
    within the tier's error (three bf16 passes: about 2^-16 relative per
    product, far under the 60 dB round-trip gate)."""
    from crlot_tpu.core.types import FftPrecision
    from crlot_tpu.fft import dispatch
    from crlot_tpu.fft.matmul_backend import _dot, hopblock_apply

    rng = np.random.default_rng(3)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    want = a.astype(np.float64) @ b
    high = dispatch._GPU_PRESETS[FftPrecision.HIGH]
    got = np.asarray(_dot(jnp.asarray(a), b, high))
    assert np.max(np.abs(got - want)) <= 2.0 ** -16 * np.max(np.abs(want))
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    kern = rng.standard_normal((4 * 512, 512)).astype(np.float32) / 64
    out = np.asarray(hopblock_apply(jnp.asarray(x), kern, 512, 8192, 768,
                                    precision=high))
    ref = np.asarray(hopblock_apply(jnp.asarray(x), kern, 512, 8192, 768))
    assert out.shape == (2, 8192)
    assert np.max(np.abs(out - ref)) <= 2.0 ** -14 * np.max(np.abs(ref))
