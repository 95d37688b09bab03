"""Example: spectral noise gating of a WAV file.

Usage: python examples/denoise.py in.wav out.wav [--threshold-db -45]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--threshold-db", type=float, default=-45.0)
    args = ap.parse_args()

    x, sr = ct.read_wav(args.infile)
    cfg = ct.StftConfig(frame_size=1024, hop_size=256, center=True)
    gate = ct.spectral.noise_gate(args.threshold_db, attenuation_db=-80.0)
    y = np.asarray(ct.round_trip(x, cfg, spectral_fn=gate))
    ct.write_wav(args.outfile, y, sr, bits=16)
    print(f"{args.infile} -> {args.outfile}: gated below {args.threshold_db} dB")


if __name__ == "__main__":
    main()
