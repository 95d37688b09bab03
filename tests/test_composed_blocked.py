"""Blocked (hop-block Toeplitz) composed round-trip vs the frame form.

`roundtrip_composed_blocked` folds the per-frame composed map AND the
overlap-add into one [L, hop] kernel applied as shifted hop-block matmuls
(2.3x fewer MACs/sample than the frame matmul at N=1024 H=256, and no
[F, N] frame matrix in HBM). Contract: identical output to
roundtrip_composed_matmul + overlap_add, including the phantom-frame-free
edge blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from crlot_tpu.core.types import WindowType
from crlot_tpu.fft.matmul_backend import (
    composed_block_supported,
    roundtrip_composed_blocked,
    roundtrip_composed_matmul,
)
from crlot_tpu.window.windows import get_window


def _ref_acc(xp, n, hop, F, w, resp, swin=None):
    frames = np.stack([xp[i * hop : i * hop + n] for i in range(F)])
    of = np.asarray(
        roundtrip_composed_matmul(jnp.asarray(frames), n, w, resp, swin)
    )
    full = (F - 1) * hop + n
    acc = np.zeros(full, np.float64)
    for f in range(F):
        acc[f * hop : f * hop + n] += of[f]
    return acc.astype(np.float32)


def _run(n, hop, total, resp, swin=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, total).astype(np.float32)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    xp = np.pad(x, n // 2, mode="reflect")
    F = (len(xp) - n) // hop + 1
    want = _ref_acc(xp, n, hop, F, w, resp, swin)
    got = np.asarray(
        roundtrip_composed_blocked(jnp.asarray(xp), n, hop, F, w, resp, swin)
    )
    assert got.shape == want.shape
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2))
    assert rel < 1e-5, f"N={n} H={hop}: rel rmse {rel}"


@pytest.mark.parametrize("n,hop", [(1024, 256), (1024, 512), (512, 128), (2048, 256)])
def test_blocked_matches_frame_form(n, hop):
    gains = 10 ** np.linspace(-0.5, 0.5, n // 2 + 1)
    _run(n, hop, 20000, gains)


@pytest.mark.parametrize("group", [2, 3, 4, 8])
def test_blocked_grouped_matches_g1(group):
    """Grouped rows (G hop-blocks per matmul row) change only the matmul
    shape, not the math."""
    n, hop = 1024, 256
    gains = 10 ** np.linspace(-0.4, 0.4, n // 2 + 1)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.9, 0.9, 20000).astype(np.float32)
    xp = np.pad(x, n // 2, mode="reflect")
    F = (len(xp) - n) // hop + 1
    a = np.asarray(
        roundtrip_composed_blocked(jnp.asarray(xp), n, hop, F, w, gains)
    )
    b = np.asarray(
        roundtrip_composed_blocked(
            jnp.asarray(xp), n, hop, F, w, gains, group=group
        )
    )
    rel = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a**2))
    assert rel < 1e-5, f"G={group}: rel rmse {rel}"


def test_blocked_complex_response():
    """Fractional-delay (complex) response rides in the kernel too."""
    n, hop = 1024, 256
    k = np.arange(n // 2 + 1)
    resp = np.exp(-2j * np.pi * k * 3.7 / n)  # 3.7-sample delay
    _run(n, hop, 16000, resp, seed=1)


def test_blocked_synthesis_window():
    n, hop = 1024, 256
    gains = np.linspace(0.25, 2.0, n // 2 + 1)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    _run(n, hop, 16000, gains, swin=w, seed=2)


def test_blocked_batched_matches_1d():
    n, hop = 1024, 256
    gains = 10 ** np.linspace(-0.3, 0.3, n // 2 + 1)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, (2, 12000)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (n // 2, n // 2)), mode="reflect")
    F = (xp.shape[-1] - n) // hop + 1
    got2 = np.asarray(
        roundtrip_composed_blocked(jnp.asarray(xp), n, hop, F, w, gains)
    )
    for c in range(2):
        got1 = np.asarray(
            roundtrip_composed_blocked(jnp.asarray(xp[c]), n, hop, F, w, gains)
        )
        # Batched matmuls may tile differently from the 1-D call; agreement
        # is float-noise level, not bit-exact.
        np.testing.assert_allclose(got1, got2[c], atol=2e-5)


def test_blocked_minimum_frames():
    """Smallest frame count where head/tail patches just meet (F = 2(R-1))."""
    n, hop = 1024, 256
    gains = np.linspace(0.5, 1.5, n // 2 + 1)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    rng = np.random.default_rng(4)
    F = 6  # 2 * (R-1) with R = 4
    xp = rng.uniform(-1, 1, (F - 1) * hop + n).astype(np.float32)
    want = _ref_acc(xp, n, hop, F, w, gains)
    got = np.asarray(
        roundtrip_composed_blocked(jnp.asarray(xp), n, hop, F, w, gains)
    )
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2))
    assert rel < 1e-5, rel


def test_blocked_gate():
    assert composed_block_supported(1024, 256)
    assert composed_block_supported(1024, 512)
    assert not composed_block_supported(1024, 192)  # hop does not divide N
    assert composed_block_supported(1000, 250)  # any hop dividing N
    assert not composed_block_supported(1024, 1024)  # no overlap (R < 2)
    assert not composed_block_supported(8192, 512)  # beyond MAX_MATMUL_NFFT
    assert not composed_block_supported(1024, 300)  # hop does not divide N


def test_blocked_identity_matches_round_trip():
    """The r3 headline route: identity response (per-bin ones) through the
    blocked kernel must reconstruct the signal like the standard pipeline
    (round_trip takes this kernel for spectral_fn=None on the GPU; on the
    CPU it does not, so drive the kernel directly)."""
    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.metrics import snr_db
    from crlot_tpu.pipeline import _norm_np, round_trip

    n, hop = 1024, 256
    cfg = StftConfig(frame_size=n, hop_size=hop, center=True)
    rng = np.random.default_rng(5)
    total = 48000
    x = rng.uniform(-0.9, 0.9, total).astype(np.float32)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    xp = np.pad(x, n // 2, mode="reflect")
    F = (len(xp) - n) // hop + 1
    full = (F - 1) * hop + n
    ones = np.ones(n // 2 + 1)
    acc = roundtrip_composed_blocked(
        jnp.asarray(xp), n, hop, F, w, ones, group=2
    )
    norm = jnp.asarray(_norm_np(cfg, F, full))
    y = np.asarray(
        (acc / jnp.maximum(norm, cfg.eps))[n // 2 : n // 2 + total]
    )
    assert snr_db(x, y) > 100, snr_db(x, y)  # CPU f32: near-perfect
    # and it agrees with the standard pipeline's reconstruction
    y_std = np.asarray(round_trip(jnp.asarray(x), cfg))
    assert snr_db(y_std, y) > 100


@pytest.mark.parametrize("resp_kind", ["identity", "eq"])
def test_blocked_norm_folded(resp_kind):
    """norm_f64 mode: 1/COLA-norm folded into the kernel must equal the
    unfolded accumulation divided by the norm (interior to f32 rounding,
    edges via the exact edge-norm division)."""
    from crlot_tpu.ola.norm import edge_norm

    n, hop = 512, 128
    total = 8192
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.9, 0.9, total).astype(np.float32)
    w = get_window(WindowType.HANN, n, True, dtype=np.float64)
    F = (total - n) // hop + 1
    full = (F - 1) * hop + n
    resp = (
        np.ones(n // 2 + 1)
        if resp_kind == "identity"
        else 10 ** np.linspace(-0.5, 0.5, n // 2 + 1)
    )
    nf64 = edge_norm(w, hop, F, full)
    got = np.asarray(roundtrip_composed_blocked(
        jnp.asarray(x), n, hop, F, w, resp, group=2, norm_f64=nf64,
    ))
    acc = np.asarray(roundtrip_composed_blocked(
        jnp.asarray(x), n, hop, F, w, resp, group=2,
    ))
    want = acc / np.maximum(nf64, 1e-8).astype(np.float32)
    err = np.abs(got - want)
    tol = 2e-5 * max(np.abs(want).max(), 1.0)
    assert err.max() < tol, err.max()


def test_blocked_norm_folded_rejects_nonconstant_interior():
    """Blackman at R = 2 has a non-constant COLA sum: folding must refuse
    rather than silently misnormalize."""
    from crlot_tpu.ola.norm import edge_norm

    n, hop = 512, 256
    w = get_window(WindowType.BLACKMAN, n, True, dtype=np.float64)
    F = 12
    full = (F - 1) * hop + n
    nf64 = edge_norm(w, hop, F, full)
    with pytest.raises(AssertionError, match="not constant"):
        roundtrip_composed_blocked(
            jnp.zeros(full), n, hop, F, w, np.ones(n // 2 + 1),
            group=2, norm_f64=nf64,
        )
