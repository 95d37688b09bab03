"""ctypes bindings for the native C++ host runtime (native/crlot_native.cpp).

Auto-builds the shared library with g++ on first import (cached next to the
source); every entry point has a pure-Python fallback, so the package works
without a toolchain. The native path is the high-throughput data loader:
WAV decode/encode and the streaming framer producing device-ready
[frames, channels, frame_size] batches.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "crlot_native.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libcrlot_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", "-o", _LIB, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src_newer = (
            os.path.exists(_LIB)
            and os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        )
        if not os.path.exists(_LIB) or src_newer:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        c = ctypes.c_int32
        i64 = ctypes.c_int64
        u64 = ctypes.c_uint64
        p8 = ctypes.POINTER(ctypes.c_uint8)
        pf = ctypes.POINTER(ctypes.c_float)
        lib.crlot_native_abi_version.restype = c
        if lib.crlot_native_abi_version() != 2:
            # Stale binary for this source: rebuild once, then give up.
            if not _build():
                return None
            lib = ctypes.CDLL(_LIB)
            lib.crlot_native_abi_version.restype = c
            if lib.crlot_native_abi_version() != 2:
                return None
        lib.crlot_wav_info.argtypes = [p8, u64] + [ctypes.POINTER(c)] * 4 + [
            ctypes.POINTER(i64)
        ]
        lib.crlot_wav_info.restype = c
        lib.crlot_wav_decode.argtypes = [p8, u64, pf]
        lib.crlot_wav_decode.restype = c
        lib.crlot_wav_encoded_size.argtypes = [i64, c, c]
        lib.crlot_wav_encoded_size.restype = i64
        lib.crlot_wav_encode.argtypes = [pf, i64, c, c, c, c, p8,
                                         ctypes.POINTER(i64)]
        lib.crlot_wav_encode.restype = c
        lib.crlot_ring_create.argtypes = [i64, c]
        lib.crlot_ring_create.restype = ctypes.c_void_p
        lib.crlot_ring_create_typed.argtypes = [i64, c, i64]
        lib.crlot_ring_create_typed.restype = ctypes.c_void_p
        lib.crlot_ring_elem_size.argtypes = [ctypes.c_void_p]
        lib.crlot_ring_elem_size.restype = i64
        lib.crlot_ring_destroy.argtypes = [ctypes.c_void_p]
        pi64 = ctypes.POINTER(i64)
        lib.crlot_ring_split.argtypes = [ctypes.c_void_p, i64, i64,
                                         pi64, pi64, pi64, pi64]
        lib.crlot_ring_split.restype = c
        lib.crlot_ring_write.argtypes = [ctypes.c_void_p, i64,
                                         ctypes.c_void_p, i64]
        lib.crlot_ring_read.argtypes = [ctypes.c_void_p, i64,
                                        ctypes.c_void_p, i64]
        lib.crlot_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.crlot_ring_capacity.restype = i64
        lib.crlot_framer_create.argtypes = [i64, i64, i64, c]
        lib.crlot_framer_create.restype = ctypes.c_void_p
        lib.crlot_framer_destroy.argtypes = [ctypes.c_void_p]
        lib.crlot_framer_push.argtypes = [ctypes.c_void_p, pf, i64]
        lib.crlot_framer_push.restype = c
        lib.crlot_framer_flush.argtypes = [ctypes.c_void_p]
        lib.crlot_framer_available.argtypes = [ctypes.c_void_p]
        lib.crlot_framer_available.restype = i64
        lib.crlot_framer_pop_batch.argtypes = [ctypes.c_void_p, pf, i64]
        lib.crlot_framer_pop_batch.restype = i64
        lib.crlot_framer_reset.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


_ERRORS = {
    -1: "not a RIFF/WAVE file",
    -2: "missing fmt/data chunk",
    -3: "unsupported format tag",
    -4: "unsupported bit depth",
    -5: "unsupported channel count",
    -6: "invalid block alignment",
}


def read_wav_native(path: str, strict: bool = True) -> Tuple[np.ndarray, int]:
    """Native read; same contract as io.wav.read_wav. Raises if lib missing."""
    from .wav import WavFormatError

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    blob = np.fromfile(path, dtype=np.uint8)
    ch = ctypes.c_int32()
    rate = ctypes.c_int32()
    bits = ctypes.c_int32()
    isf = ctypes.c_int32()
    frames = ctypes.c_int64()
    p = blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.crlot_wav_info(p, blob.size, ch, rate, bits, isf, frames)
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    if strict and ch.value > 2:
        raise WavFormatError(f"{path}: unsupported channel count {ch.value}")
    out = np.empty(frames.value * ch.value, dtype=np.float32)
    rc = lib.crlot_wav_decode(p, blob.size, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    data = np.ascontiguousarray(out.reshape(frames.value, ch.value).T)
    return data, rate.value


def write_wav_native(
    path: str,
    data: np.ndarray,
    sample_rate: int,
    bits: int = 16,
    float_format: bool = False,
    strict: bool = True,
) -> None:
    from .wav import WavFormatError

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    channels, frames = x.shape
    if channels < 1 or (strict and channels > 2):
        raise WavFormatError(f"unsupported channel count {channels}")
    if float_format:
        bits = 32
    if bits not in (16, 24, 32):
        raise WavFormatError(f"unsupported bit depth {bits}")
    interleaved = np.ascontiguousarray(x.T).reshape(-1)
    size = lib.crlot_wav_encoded_size(frames, channels, bits)
    out = np.empty(size, dtype=np.uint8)
    out_len = ctypes.c_int64()
    rc = lib.crlot_wav_encode(
        interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, sample_rate, bits, 1 if float_format else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_len,
    )
    if rc != 0:
        raise WavFormatError(f"{path}: {_ERRORS.get(rc, rc)}")
    out[: out_len.value].tofile(path)


class NativeRing:
    """Dtype-generic native ring buffer (reference: dsp/ring/ring_buffer.cc,
    instantiated for float/double/int16/int32/uint16/uint32 at :207-213).

    Wrap-around write/contiguous read over a fixed capacity, with an optional
    2x shadow mirror so reads never wrap (the reference's batch-friendly
    layout). Element type is fixed at construction via numpy dtype.
    """

    DTYPES = ("float32", "float64", "int16", "int32", "uint16", "uint32")

    def __init__(self, capacity: int, dtype="float32",
                 shadow: bool = False) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        dt = np.dtype(dtype)
        if dt.name not in self.DTYPES:
            raise ValueError(f"unsupported ring dtype {dt.name}; "
                             f"one of {self.DTYPES}")
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self._lib = lib
        self.dtype = dt
        self.capacity = capacity
        self._h = lib.crlot_ring_create_typed(
            capacity, 1 if shadow else 0, dt.itemsize
        )
        if not self._h:
            raise RuntimeError("ring creation failed")

    def write(self, start: int, src: np.ndarray) -> None:
        data = np.ascontiguousarray(src, dtype=self.dtype).reshape(-1)
        self._lib.crlot_ring_write(
            self._h, start, data.ctypes.data_as(ctypes.c_void_p), data.size
        )

    def read(self, start: int, n: int) -> np.ndarray:
        out = np.empty(min(n, self.capacity), dtype=self.dtype)
        self._lib.crlot_ring_read(
            self._h, start, out.ctypes.data_as(ctypes.c_void_p), out.size
        )
        return out

    def split(self, start: int, n: int):
        """(off0, len0, off1, len1) span view arithmetic (ring_buffer.cc:43-85)."""
        o0, l0 = ctypes.c_int64(), ctypes.c_int64()
        o1, l1 = ctypes.c_int64(), ctypes.c_int64()
        self._lib.crlot_ring_split(self._h, start, n, o0, l0, o1, l1)
        return o0.value, l0.value, o1.value, l1.value

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.crlot_ring_destroy(h)
            self._h = None


class NativeFramer:
    """C++ streaming framer emitting [frames, channels, frame_size] batches.

    Same semantics as crlot_tpu.frame.streaming.Framer (push/flush/available/
    pop_batch) but with the hot deinterleave loop in native code — this is the
    host data-loader feeding the device.
    """

    def __init__(self, frame_size: int, hop_size: int, channels: int = 1,
                 zero_pad: bool = True) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        if frame_size <= 0 or hop_size <= 0 or channels <= 0:
            raise ValueError("frame_size, hop_size, channels must be > 0")
        self._lib = lib
        self.frame_size = frame_size
        self.hop_size = hop_size
        self.channels = channels
        self._h = lib.crlot_framer_create(
            frame_size, hop_size, channels, 1 if zero_pad else 0
        )
        if not self._h:
            raise RuntimeError("framer creation failed")

    def push(self, interleaved: np.ndarray) -> None:
        data = np.ascontiguousarray(interleaved, dtype=np.float32).reshape(-1)
        if data.size % self.channels != 0:
            raise ValueError(
                f"pushed {data.size} samples not a multiple of channels"
            )
        rc = self._lib.crlot_framer_push(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            data.size // self.channels,
        )
        if rc != 0:
            raise RuntimeError("cannot push after flush()")

    def flush(self) -> None:
        self._lib.crlot_framer_flush(self._h)

    def available(self) -> int:
        return int(self._lib.crlot_framer_available(self._h))

    def pop_batch(self, max_frames: Optional[int] = None) -> np.ndarray:
        n = self.available()
        if max_frames is not None:
            n = min(n, max_frames)
        out = np.zeros((n, self.channels, self.frame_size), dtype=np.float32)
        if n:
            got = self._lib.crlot_framer_pop_batch(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
            )
            out = out[:got]
        return out

    def reset(self) -> None:
        self._lib.crlot_framer_reset(self._h)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.crlot_framer_destroy(h)
            self._h = None
