"""OLA flat-array kernels vs a numpy reference (reference: tests/kernels_test.cc).

The reference checks every SIMD kernel against its scalar form within ±1 ULP
across sizes straddling SIMD lane boundaries {0,1,7,15,16,17,...,4096}
(kernels_test.cc:214-317, :375-428). Here the jitted jnp kernels are checked
against float32 numpy at the same sizes. XLA may contract `a + b*c` into one fused multiply-add,
which skips the product's rounding, so the elementwise ops are checked
against the exact (float64) value within the float32 rounding bound of
their expression: half an ULP of the operand scale per rounded operation.
"""

import jax
import numpy as np
import pytest

from crlot_tpu.ola import kernels as K

# Sizes straddling 128-lane and 8x128-tile boundaries (+ reference's sweep)
SIZES = [1, 7, 15, 16, 17, 127, 128, 129, 1023, 1024, 1025, 4096, 16384]


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Max bit-level ULP distance (reference: kernels_test.cc:16-41)."""
    ai = np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, dtype=np.float32).view(np.int32).astype(np.int64)
    # Map to monotonic ordered-int space
    ai = np.where(ai < 0, np.int64(-(2**31)) - ai, ai)
    bi = np.where(bi < 0, np.int64(-(2**31)) - bi, bi)
    return int(np.max(np.abs(ai - bi))) if ai.size else 0


def _rounding_ulps(got, exact, scale) -> float:
    """Max |got - exact| in ULPs of the float32 operand scale."""
    spacing = np.spacing(np.asarray(scale, np.float32)).astype(np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - exact) / spacing))


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_axpy_ulp(n):
    dst, src = _rand(n, 1), _rand(n, 2)
    got = np.asarray(K.axpy(dst, src, 1.5))
    prod = src.astype(np.float64) * 1.5
    exact = dst + prod
    # two roundings: the product and the sum
    assert _rounding_ulps(got, exact, np.abs(dst) + np.abs(prod)) <= 1.0, f"n={n}"


@pytest.mark.parametrize("n", SIZES)
def test_axpy_windowed_ulp(n):
    dst, src, win = _rand(n, 3), _rand(n, 4), _rand(n, 5)
    got = np.asarray(K.axpy_windowed(dst, src, win, 0.75))
    prod = src.astype(np.float64) * win * 0.75
    exact = dst + prod
    # three roundings: two products and the sum
    assert _rounding_ulps(got, exact, np.abs(dst) + np.abs(prod)) <= 1.5, f"n={n}"


@pytest.mark.parametrize("n", SIZES)
def test_normalize_and_clear_ulp(n):
    acc = _rand(n, 6)
    norm = np.abs(_rand(n, 7))
    norm[::5] = 0.0  # exercise the eps guard
    got, cleared = K.normalize_and_clear(acc, norm, eps=1e-8)
    want = acc / np.maximum(norm, np.float32(1e-8))
    # The CPU divides with correct rounding. On the GPU the divide is PTX
    # div.full.f32, up to 2 ULP from the exact quotient (so up to 3 from
    # numpy's correctly rounded one).
    limit = 3 if jax.default_backend() == "gpu" else 1
    assert _ulp_diff(np.asarray(got), want) <= limit, f"n={n}"
    assert np.all(np.asarray(cleared) == 0.0)


def test_axpy_semantics():
    dst = np.array([1.0, 2.0], dtype=np.float32)
    src = np.array([10.0, 20.0], dtype=np.float32)
    np.testing.assert_allclose(np.asarray(K.axpy(dst, src, 0.5)), [6.0, 12.0])


def test_axpy_windowed_semantics():
    dst = np.zeros(3, dtype=np.float32)
    src = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    win = np.array([0.5, 0.5, 0.0], dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(K.axpy_windowed(dst, src, win, 2.0)), [1.0, 2.0, 0.0]
    )


def test_normalize_eps_guard_semantics():
    acc = np.array([1.0, 1.0], dtype=np.float32)
    norm = np.array([0.0, 2.0], dtype=np.float32)
    out, _ = K.normalize_and_clear(acc, norm, eps=0.5)
    np.testing.assert_allclose(np.asarray(out), [2.0, 0.5])


def test_empty_and_mismatch():
    empty = np.zeros(0, dtype=np.float32)
    assert K.axpy(empty, empty).size == 0
    with pytest.raises(ValueError):
        K.axpy(np.zeros(3, dtype=np.float32), np.zeros(4, dtype=np.float32))
    with pytest.raises(ValueError):
        K.axpy_windowed(
            np.zeros(3, dtype=np.float32),
            np.zeros(3, dtype=np.float32),
            np.zeros(2, dtype=np.float32),
        )


def test_dispatch_info():
    import jax

    info = K.kernel_dispatch_info()
    assert info == {
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "num_devices": len(jax.devices()),
    }
    K.print_kernel_dispatch_info()


def test_normalize_and_clear_mismatch_and_empty():
    """The drain pass validates shapes like the axpy pair and passes an
    empty ring through unchanged."""
    with pytest.raises(ValueError):
        K.normalize_and_clear(np.zeros(3, np.float32), np.ones(4, np.float32))
    out, cleared = K.normalize_and_clear(np.zeros(0, np.float32),
                                         np.zeros(0, np.float32))
    assert out.size == 0 and cleared.size == 0
