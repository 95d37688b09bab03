"""Example: mel-spectrogram / MFCC feature extraction from a WAV.

The whole feature stack — framing, the matmul DFT, |.|^2, the mel
filterbank matmul, dB, and the DCT matmul — runs as one jitted program per channel.

Usage: python examples/extract_features.py in.wav out.npz [--n-mels 64]
                                           [--n-mfcc 13]
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
    ap.add_argument("outfile", help=".npz with mel, mfcc, centroid arrays")
    ap.add_argument("--n-mels", type=int, default=64)
    ap.add_argument("--n-mfcc", type=int, default=13)
    ap.add_argument("--frame-size", type=int, default=1024)
    ap.add_argument("--hop-size", type=int, default=256)
    args = ap.parse_args()

    x, sr = ct.read_wav(args.infile)
    mono = np.mean(x, axis=0) if x.ndim == 2 else x
    cfg = ct.StftConfig(
        frame_size=args.frame_size, hop_size=args.hop_size, center=True
    )

    mel = np.asarray(
        ct.mel_spectrogram(mono, cfg, float(sr), n_mels=args.n_mels)
    )
    coeffs = np.asarray(
        ct.mfcc(mono, cfg, float(sr), n_mfcc=args.n_mfcc,
                n_mels=args.n_mels)
    )
    d1 = np.asarray(ct.delta(coeffs))
    centroid = np.asarray(ct.spectral_centroid(mono, cfg, float(sr)))
    flatness = np.asarray(ct.spectral_flatness(mono, cfg))
    chroma = np.asarray(ct.chroma(mono, cfg, float(sr)))
    contrast = np.asarray(ct.spectral_contrast(mono, cfg, float(sr)))
    tonnetz = np.asarray(ct.tonnetz(mono, cfg, float(sr)))
    pcen = np.asarray(
        ct.pcen(ct.mel_spectrogram(mono, cfg, float(sr),
                                   n_mels=args.n_mels),
                float(sr) / args.hop_size)
    )
    onset_mask, onset_env = ct.detect_onsets(mono, cfg, float(sr))
    onsets = np.nonzero(np.asarray(onset_mask))[0]
    bpm = float(ct.tempo(mono, cfg, float(sr)))

    np.savez(
        args.outfile, mel=mel, mfcc=coeffs, mfcc_delta=d1,
        centroid=centroid, flatness=flatness, chroma=chroma,
        contrast=contrast, tonnetz=tonnetz, pcen=pcen, tempo_bpm=bpm,
        onset_env=np.asarray(onset_env), onset_frames=onsets,
        sample_rate=sr, hop_size=args.hop_size,
    )
    print(
        f"{args.infile}: {mel.shape[0]} frames -> mel{mel.shape} "
        f"mfcc{coeffs.shape} chroma{chroma.shape}; median centroid "
        f"{float(np.median(centroid)):.0f} Hz, median flatness "
        f"{float(np.median(flatness)):.3f}, {len(onsets)} onsets, "
        f"{bpm:.0f} BPM -> {args.outfile}"
    )


if __name__ == "__main__":
    main()
