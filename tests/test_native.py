"""Native C++ runtime vs Python implementation equivalence.

The native codec/framer must be drop-in bit-compatible with the Python path
(the dual-implementation equivalence pattern of SURVEY.md §4 applied to the
host runtime).
"""

import numpy as np
import pytest

from crlot_tpu.frame.streaming import Framer
from crlot_tpu.io import native as N
from crlot_tpu.io.wav import read_wav, write_wav

pytestmark = pytest.mark.skipif(
    not N.native_available(), reason="native toolchain unavailable"
)


def _sig(n, c=1, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (c, n)).astype(np.float32)


@pytest.mark.parametrize("bits,float_format", [(16, False), (24, False), (32, False), (32, True)])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_native_matches_python(tmp_path, bits, float_format, channels):
    x = _sig(4321, channels)
    p_py = str(tmp_path / "py.wav")
    p_nat = str(tmp_path / "nat.wav")
    write_wav(p_py, x, 48000, bits=bits, float_format=float_format)
    N.write_wav_native(p_nat, x, 48000, bits=bits, float_format=float_format)
    with open(p_py, "rb") as a, open(p_nat, "rb") as b:
        assert a.read() == b.read()  # byte-identical files
    y_py, r1 = read_wav(p_py)
    y_nat, r2 = N.read_wav_native(p_nat)
    assert r1 == r2 == 48000
    np.testing.assert_array_equal(y_py, y_nat)


def test_native_reads_oboe_like_asset(tmp_path, oboe):
    """A 44.1 kHz 16-bit WAV like the reference's oboe asset decodes the
    same through both codecs."""
    from crlot_tpu.io.wav import write_wav

    x, sr = oboe
    path = str(tmp_path / "oboe.wav")
    write_wav(path, x, sr, bits=16)
    a, ra = read_wav(path)
    b, rb = N.read_wav_native(path)
    assert ra == rb
    np.testing.assert_array_equal(a, b)


def test_native_rejects_garbage(tmp_path):
    from crlot_tpu.io.wav import WavFormatError

    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"definitely not a wav")
    with pytest.raises(WavFormatError):
        N.read_wav_native(p)


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_native_framer_matches_python(channels):
    rng = np.random.default_rng(1)
    total = 997
    inter = rng.uniform(-1, 1, total * channels).astype(np.float32)
    py = Framer(64, 16, channels=channels)
    nat = N.NativeFramer(64, 16, channels=channels)
    for chunk in np.array_split(inter.reshape(total, channels), 7):
        py.push(chunk.reshape(-1))
        nat.push(chunk.reshape(-1))
        assert py.available() == nat.available()
        a = py.pop_batch()
        b = nat.pop_batch()
        np.testing.assert_array_equal(a, b)
    py.flush()
    nat.flush()
    np.testing.assert_array_equal(py.pop_batch(), nat.pop_batch())


def test_native_framer_zero_pad_tail():
    nat = N.NativeFramer(8, 4, channels=1)
    nat.push(np.ones(10, dtype=np.float32))
    assert nat.available() == 1
    nat.flush()
    batch = nat.pop_batch()
    assert batch.shape[0] == 2
    # partial frame starts at the read cursor (sample 4): six ones + pad
    np.testing.assert_array_equal(batch[1, 0], [1, 1, 1, 1, 1, 1, 0, 0])


def test_native_framer_push_after_flush():
    nat = N.NativeFramer(8, 4)
    nat.flush()
    with pytest.raises(RuntimeError):
        nat.push(np.zeros(8, dtype=np.float32))


def test_native_ring_split_semantics():
    import ctypes

    lib = N.get_lib()
    h = lib.crlot_ring_create(16, 0)
    assert h
    try:
        o0 = ctypes.c_int64(); l0 = ctypes.c_int64()
        o1 = ctypes.c_int64(); l1 = ctypes.c_int64()
        # no wrap
        assert lib.crlot_ring_split(h, 2, 8, o0, l0, o1, l1) == 1
        assert (o0.value, l0.value) == (2, 8)
        # wrap: start 12 len 8 -> [12,16) + [0,4)
        assert lib.crlot_ring_split(h, 12, 8, o0, l0, o1, l1) == 2
        assert (o0.value, l0.value, o1.value, l1.value) == (12, 4, 0, 4)
        # over-capacity clamps to capacity
        assert lib.crlot_ring_split(h, 0, 100, o0, l0, o1, l1) == 1
        assert l0.value == 16
        # beyond-capacity start wraps
        lib.crlot_ring_split(h, 35, 4, o0, l0, o1, l1)
        assert o0.value == 3
    finally:
        lib.crlot_ring_destroy(h)


def test_native_ring_write_read_shadow():
    import ctypes

    lib = N.get_lib()
    for shadow in (0, 1):
        h = lib.crlot_ring_create(8, shadow)
        try:
            src = np.arange(1, 7, dtype=np.float32)
            lib.crlot_ring_write(
                h, 5, src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 6
            )
            out = np.zeros(6, dtype=np.float32)
            lib.crlot_ring_read(
                h, 5, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 6
            )
            np.testing.assert_array_equal(out, src)  # wrap-around round trip
        finally:
            lib.crlot_ring_destroy(h)


def test_native_ring_zero_capacity_rejected():
    lib = N.get_lib()
    assert not lib.crlot_ring_create(0, 0)
    assert not lib.crlot_ring_create(-5, 0)


def test_native_wav_fuzz(tmp_path):
    """The C++ codec must reject or partially decode malformed WAVs cleanly
    — clean WavFormatError, finite samples, no crash (dr_wav-posture,
    io/wav.cc:30-58)."""
    import numpy as np

    from crlot_tpu.io.native import native_available, read_wav_native
    from crlot_tpu.io.wav import WavFormatError, write_wav

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")
    good = tmp_path / "good.wav"
    rng = np.random.default_rng(0)
    write_wav(str(good), rng.uniform(-0.5, 0.5, 2000).astype(np.float32),
              16000, bits=16)
    blob = good.read_bytes()
    cases = [blob[:c]
             for c in (0, 3, 11, 12, 20, 43, 44, len(blob) // 2,
                       len(blob) - 1)]
    for pos in (0, 8, 20, 22, 34, 40):
        b = bytearray(blob)
        b[pos] ^= 0xFF
        cases.append(bytes(b))
    cases += [b"", b"RIFF" + b"\x00" * 100, rng.bytes(256)]
    bad = tmp_path / "bad.wav"
    for i, payload in enumerate(cases):
        bad.write_bytes(payload)
        try:
            data, sr = read_wav_native(str(bad))
        except (WavFormatError, ValueError) as e:
            assert str(e), f"case {i}"
            continue
        assert np.isfinite(np.asarray(data)).all(), f"case {i}"
        assert sr > 0, f"case {i}"


@pytest.mark.parametrize(
    "dtype", ["float32", "float64", "int16", "int32", "uint16", "uint32"]
)
def test_native_ring_dtype_generic(dtype):
    """Reference instantiates RingBuffer<T> for six element types
    (ring_buffer.cc:207-213); the native ring carries the same contract."""
    from crlot_tpu.io.native import NativeRing

    rng = np.random.default_rng(7)
    for shadow in (False, True):
        ring = NativeRing(12, dtype=dtype, shadow=shadow)
        info = np.iinfo(dtype) if np.issubdtype(np.dtype(dtype), np.integer) \
            else None
        raw = rng.integers(info.min, info.max, 9) if info else \
            rng.uniform(-1, 1, 9)
        data = np.asarray(raw, dtype=dtype)
        ring.write(10, data)  # wraps: 2 at [10,12), 7 at [0,7)
        got = ring.read(10, 9)
        np.testing.assert_array_equal(got, data)
        assert got.dtype == np.dtype(dtype)
        # second write elsewhere must not disturb the wrapped region
        ring.write(7, data[:3])
        np.testing.assert_array_equal(ring.read(10, 9), data)


def test_native_ring_rejects_bad_dtype():
    from crlot_tpu.io.native import NativeRing

    with pytest.raises(ValueError):
        NativeRing(8, dtype="complex64")
    with pytest.raises(ValueError):
        NativeRing(0)
