"""Demo / integration showcase: the reference main() rebuilt in JAX.

Reference: main/main.cc:68-427 — device capability report, WAV read, FFT peak
analysis (top-10 table), tone WAV write, streaming 44.1k->48k resample, SIMD
kernel demo. Run:  python -m crlot_tpu.demo [input.wav] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _device_report() -> None:
    # cpu_features CPU report analog (main.cc:69-96): device kind + dispatch.
    import jax

    from .ola.kernels import kernel_dispatch_info

    print("== device report ==")
    for k, v in kernel_dispatch_info().items():
        print(f"  {k}: {v}")
    print(f"  jax {jax.__version__}")


def _load_signal(path: str | None):
    from .io.wav import read_wav

    if path is not None:
        data, sr = read_wav(path)
        print(f"== input == {path}: {data.shape[0]} ch, "
              f"{data.shape[1]} frames @ {sr} Hz")
        return data, sr
    print("== input == (no wav given; synthesizing 2 s A440 + harmonics)")
    sr = 44100
    t = np.arange(sr * 2) / sr
    x = sum(a * np.sin(2 * np.pi * f * 440 * t)
            for f, a in [(1, 0.5), (2, 0.25), (3, 0.12)])
    return np.asarray([x], dtype=np.float32), sr


def _peak_analysis(mono: np.ndarray, sr: int) -> None:
    # FFT-size pick + Hann + rFFT + top-10 peak table (main.cc:136-208).
    import jax.numpy as jnp

    from .core.types import WindowType
    from .fft.dispatch import rfft
    from .window.windows import get_window

    import jax

    n = 4096
    while n > len(mono):
        n //= 2
    seg = mono[:n] * get_window(WindowType.HANN, n, periodic=True)
    # One jitted program; only the real magnitude comes back to the host.
    mag = np.asarray(
        jax.jit(lambda s: jnp.abs(rfft(s, n)))(jnp.asarray(seg))
    )
    top = np.argsort(mag)[::-1][:10]
    print(f"== spectrum == N={n}, top-10 peaks:")
    print(f"  {'bin':>6} {'freq (Hz)':>10} {'mag (dB)':>9}")
    ref = mag.max() or 1.0
    for k in top:
        print(f"  {k:>6} {k * sr / n:>10.1f} {20 * np.log10(max(mag[k], 1e-12) / ref):>9.1f}")


def _tone_write(out_dir: str, sr: int) -> None:
    # 440 Hz tone WAV write (main.cc:212-236).
    from .io.wav import write_wav

    t = np.arange(sr) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    path = os.path.join(out_dir, "tone440.wav")
    write_wav(path, tone, sr, bits=16)
    print(f"== tone == wrote {path}")


def _resample_demo(mono: np.ndarray, sr: int, out_dir: str) -> None:
    # Streaming resample demo (r8brain chunk loop analog, main.cc:238-352).
    from .io.wav import write_wav
    from .resample.polyphase import output_length, resample_chunked

    target = 48000 if sr != 48000 else 44100
    t0 = time.time()
    y = resample_chunked(mono, sr, target, chunk=65536)
    dt = time.time() - t0
    assert len(y) == output_length(len(mono), sr, target)
    path = os.path.join(out_dir, f"resampled_{target}.wav")
    write_wav(path, y, target, bits=16)
    print(f"== resample == {sr} -> {target} Hz: {len(mono)} -> {len(y)} "
          f"samples in {dt * 1e3:.1f} ms; wrote {path}")


def _round_trip_demo(mono: np.ndarray, sr: int) -> None:
    from .core.types import StftConfig
    from .metrics import snr_db
    from .pipeline import round_trip

    import jax

    cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    fn = jax.jit(lambda s: round_trip(s, cfg))  # one program, no eager ops
    t0 = time.time()
    y = np.asarray(fn(mono))
    dt = time.time() - t0
    print(f"== round-trip == N=1024 H=256: SNR {snr_db(mono, y):.1f} dB, "
          f"{len(mono) / dt / 1e6:.1f} Msamples/s (incl. host transfers)")


def _kernel_demo() -> None:
    # Highway ScalePcmData SIMD demo analog (main.cc:354-383).
    from .ola.kernels import axpy_windowed

    x = np.linspace(-1, 1, 8, dtype=np.float32)
    w = np.full(8, 0.5, dtype=np.float32)
    print("== ola kernel == axpy_windowed(0, x, 0.5w, gain=2):",
          np.asarray(axpy_windowed(np.zeros(8, dtype=np.float32), x, w, 2.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("wav", nargs="?", default=None)
    ap.add_argument("--out-dir", default=os.path.join("out", "demo"))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    _device_report()
    data, sr = _load_signal(args.wav)
    mono = data.mean(axis=0).astype(np.float32)  # mixdown (main.cc:150-166)
    _peak_analysis(mono, sr)
    _tone_write(args.out_dir, sr)
    _resample_demo(mono, sr, args.out_dir)
    _round_trip_demo(mono, sr)
    _kernel_demo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
