"""One-fusion OLA + normalise vs the DUS-chain reference: bit-exact."""

import numpy as np
import pytest

from crlot_tpu.ola.fused import ola_normalized
from crlot_tpu.ola.norm import edge_norm
from crlot_tpu.ola.reference import normalize, overlap_add
from crlot_tpu.window.windows import get_window
from crlot_tpu.core.types import WindowType


@pytest.mark.parametrize("n,hop,f", [
    (1024, 256, 37),
    (1024, 512, 16),
    (256, 128, 9),
    (512, 128, 100),
    (400, 160, 11),   # N not a multiple of hop: frames zero-pad to R*H
])
def test_fused_matches_reference_bitexact(n, hop, f):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((f, n)).astype(np.float32)
    out_len = (f - 1) * hop + n
    w = get_window(WindowType.HANN, n, periodic=True)
    norm = edge_norm(w, hop, f, out_len)
    want = np.asarray(normalize(overlap_add(frames, hop, out_len), norm))
    got = np.asarray(ola_normalized(frames, norm, hop, out_len))
    np.testing.assert_array_equal(got, want)


def test_fused_out_len_shorter_than_span():
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((12, 256)).astype(np.float32)
    out_len = 5 * 128 + 7  # not hop-aligned, shorter than full span
    norm = np.ones(out_len, dtype=np.float32)
    want = np.asarray(overlap_add(frames, 128, out_len))
    got = np.asarray(ola_normalized(frames, norm, 128, out_len))
    np.testing.assert_array_equal(got, want)


def test_fused_out_len_longer_than_span():
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((4, 256)).astype(np.float32)
    out_len = 3 * 128 + 256 + 50  # past the last frame: zeros
    norm = np.ones(out_len, dtype=np.float32)
    want = np.asarray(overlap_add(frames, 128, out_len))
    got = np.asarray(ola_normalized(frames, norm, 128, out_len))
    np.testing.assert_array_equal(got, want)
    assert not got[-50:].any()


def test_fused_eps_guard():
    frames = np.ones((4, 256), dtype=np.float32)
    out_len = 3 * 128 + 256
    norm = np.zeros(out_len, dtype=np.float32)
    got = np.asarray(ola_normalized(frames, norm, 128, out_len, eps=0.5))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, np.asarray(overlap_add(frames, 128, out_len)) / 0.5
    )


def test_fused_batched_matches_reference():
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((3, 2, 9, 256)).astype(np.float32)
    out_len = 8 * 128 + 256
    w = get_window(WindowType.HANN, 256, periodic=True)
    norm = edge_norm(w, 128, 9, out_len)
    got = np.asarray(ola_normalized(frames, norm, 128, out_len))
    want = np.asarray(normalize(overlap_add(frames, 128, out_len), norm))
    assert got.shape == (3, 2, out_len)
    np.testing.assert_array_equal(got, want)
