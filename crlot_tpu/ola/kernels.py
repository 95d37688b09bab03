"""The reference's flat-array OLA kernels as jnp expressions.

Reference: dsp/ola/kernels.{h,cc} + kernels_hwy.cc — three flat-array
kernels (axpy, axpy_windowed, normalize_and_clear) in scalar and
Highway-SIMD form with runtime dispatch. Each is one elementwise
expression, which XLA fuses into whatever produces or consumes it, so one
jitted form serves every backend.

Dispatch introspection (`get_supported_targets` etc., kernels.cc:58-147)
maps to `kernel_dispatch_info()`, which reports the JAX device instead of
AVX2/NEON lane counts.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

# Max frame size the ring shadow sizing assumed in the reference
# (dsp/ola/kernels.h:11); kept as the tested upper bound for sweeps.
MAX_FRAME_SIZE = 16384


@jax.jit
def _axpy(dst: jnp.ndarray, src: jnp.ndarray, gain) -> jnp.ndarray:
    return dst + src * jnp.float32(gain)


def axpy(dst: jnp.ndarray, src: jnp.ndarray, gain=1.0) -> jnp.ndarray:
    """Returns dst + src*gain, the functional form of the in-place reference
    (kernels.cc:18-22)."""
    dst = jnp.asarray(dst, dtype=jnp.float32)
    src = jnp.asarray(src, dtype=jnp.float32)
    if dst.shape != src.shape:
        raise ValueError(f"shape mismatch {dst.shape} vs {src.shape}")
    if dst.size == 0:
        return dst
    return _axpy(dst, src, gain)


@jax.jit
def _axpy_windowed(dst, src, win, gain) -> jnp.ndarray:
    return dst + src * win * jnp.float32(gain)


def axpy_windowed(dst, src, win, gain=1.0) -> jnp.ndarray:
    """Returns dst + src*win*gain (kernels.cc:24-28)."""
    dst = jnp.asarray(dst, dtype=jnp.float32)
    src = jnp.asarray(src, dtype=jnp.float32)
    win = jnp.asarray(win, dtype=jnp.float32)
    if not (dst.shape == src.shape == win.shape):
        raise ValueError(
            f"shape mismatch {dst.shape} vs {src.shape} vs {win.shape}"
        )
    if dst.size == 0:
        return dst
    return _axpy_windowed(dst, src, win, gain)


@jax.jit
def _normalize_and_clear(acc, norm, eps):
    out = acc / jnp.maximum(norm, jnp.float32(eps))
    return out, jnp.zeros_like(acc)


def normalize_and_clear(acc, norm, eps=1e-8):
    """Returns (out, cleared_acc): the fused divide-and-zero drain pass that
    lets the OLA ring be reused (reference: kernels.cc:30-36)."""
    acc = jnp.asarray(acc, dtype=jnp.float32)
    norm = jnp.asarray(norm, dtype=jnp.float32)
    if acc.shape != norm.shape:
        raise ValueError(f"shape mismatch {acc.shape} vs {norm.shape}")
    if acc.size == 0:
        return acc, acc
    return _normalize_and_clear(acc, norm, eps)


# --- dispatch introspection (reference: kernels.cc:58-147) ---


def kernel_dispatch_info() -> Dict[str, object]:
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "num_devices": len(jax.devices()),
    }


def print_kernel_dispatch_info() -> None:
    for k, v in kernel_dispatch_info().items():
        print(f"{k}: {v}")
