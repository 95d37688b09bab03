"""Example: FIR filtering a WAV through the composed one-matmul round-trip.

A fixed FIR filter's frequency response (complex: magnitude AND phase)
composes with the DFT bases into a single [N, N] matrix on the host, so
the whole frame -> spectrum -> filter -> frame chain runs as ONE
matmul per frame batch — cheaper than an identity round-trip.

Usage: python examples/fir_filter.py in.wav out.wav [--cutoff-hz 4000]
"""

import argparse

import numpy as np

import os as _os
import sys as _sys

# allow `python examples/<name>.py` without installing the package
_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import crlot_tpu as ct


def lowpass_taps(cutoff_hz: float, sr: float, num_taps: int = 127):
    """Windowed-sinc lowpass, designed in f64 (linear phase)."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2
    fc = cutoff_hz / sr
    h = 2 * fc * np.sinc(2 * fc * n)
    h *= np.hamming(num_taps)
    return h / h.sum()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--cutoff-hz", type=float, default=4000.0)
    args = ap.parse_args()

    x, sr = ct.read_wav(args.infile)
    cfg = ct.StftConfig(frame_size=1024, hop_size=256, center=True)
    taps = lowpass_taps(args.cutoff_hz, sr)
    resp = ct.spectral.fir_frequency_response(taps, cfg.frame_size)
    filt = ct.spectral.per_bin_filter(resp)  # complex response -> composes
    y = np.asarray(ct.round_trip(x, cfg, spectral_fn=filt))
    ct.write_wav(args.outfile, y, sr, bits=16)
    print(
        f"{args.infile} -> {args.outfile}: "
        f"lowpass {args.cutoff_hz:.0f} Hz ({len(taps)} taps, one-matmul path)"
    )


if __name__ == "__main__":
    main()
