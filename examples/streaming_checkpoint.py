"""Example: checkpointed streaming STFT round-trip of a long WAV.

Processes a file hop-by-hop through the streaming Framer -> FFT plan ->
streaming OLA chain, checkpointing the stream state every few seconds of
audio; re-run with the same arguments after an interruption and it resumes
from the last checkpoint, producing output bit-identical to an unbroken run
(tests/test_checkpoint.py asserts this property).

Usage: python examples/streaming_checkpoint.py in.wav out.npy \
           [--ckpt out/stream.ckpt.npz] [--crash-after-seconds S]
"""

import argparse
import os

import numpy as np

import os as _os
import sys as _sys

# allow `python examples/<name>.py` without installing the package
_sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import crlot_tpu as ct
from crlot_tpu.checkpoint import load_stream_state, save_stream_state
from crlot_tpu.core.types import OLAConfig
from crlot_tpu.ola.streaming import (
    ola_add_frame,
    ola_flush,
    ola_init,
    ola_produce,
    make_norm_ring,
)


def main() -> None:
    import jax.numpy as jnp

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--ckpt", default=os.path.join("out", "stream.ckpt.npz"))
    ap.add_argument("--frame-size", type=int, default=1024)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--ckpt-every-seconds", type=float, default=2.0)
    ap.add_argument(
        "--crash-after-seconds", type=float, default=None,
        help="simulate an interruption after S seconds of audio",
    )
    args = ap.parse_args()

    x, sr = ct.read_wav(args.infile)
    mono = np.asarray(x[0])
    n, hop = args.frame_size, args.hop
    w = ct.get_window(ct.WindowType.HANN, n)
    plan = ct.make_fft_plan(
        ct.FftPlanDesc(domain=ct.FftDomain.REAL, nfft=n)
    )
    cfg = OLAConfig(sample_rate=sr, frame_size=n, hop_size=hop, channels=1)
    norm_ring = jnp.asarray(make_norm_ring(cfg, w))
    win = jnp.asarray(w)

    start_frame = 0
    state = ola_init(cfg)
    pieces = []
    if os.path.exists(args.ckpt):
        state, meta = load_stream_state(args.ckpt)
        start_frame = meta["frame_index"]
        pieces = [np.load(args.ckpt + ".out.npy")]
        print(f"resuming at frame {start_frame}")

    framer = ct.Framer(n, hop, channels=1)
    framer.push(mono[: None])
    frames = framer.pop_batch()  # [F, n]
    total_frames = frames.shape[0]
    ckpt_every = max(1, int(args.ckpt_every_seconds * sr / hop))
    crash_at = (
        None
        if args.crash_after_seconds is None
        else start_frame + int(args.crash_after_seconds * sr / hop)
    )

    for f in range(start_frame, total_frames):
        spec = plan.forward(jnp.asarray(frames[f]) * win)
        out_frame = plan.inverse(spec)  # identity processing
        # Window exactly once: it was applied before the FFT, so the OLA add
        # is unwindowed while norm_ring stays the COLA sum-of-window (the
        # reference's BLK-01 double-window bug is passing `win` here too).
        state = ola_add_frame(
            state, out_frame.reshape(1, n), jnp.int32(f * hop), None, cfg
        )
        state, out, count = ola_produce(state, norm_ring, cfg, hop)
        pieces.append(np.asarray(out[0, : int(count)]))
        if (f + 1) % ckpt_every == 0:
            save_stream_state(args.ckpt, state, cfg, frame_index=f + 1)
            np.save(args.ckpt + ".out.npy", np.concatenate(pieces))
            if crash_at is not None and f + 1 >= crash_at:
                print(f"simulated crash after frame {f + 1}; rerun to resume")
                return

    state = ola_flush(state)
    state, out, count = ola_produce(state, norm_ring, cfg, n)
    pieces.append(np.asarray(out[0, : int(count)]))
    y = np.concatenate(pieces)
    np.save(args.outfile, y)
    # Streaming OLA is sample-aligned (no latency shift); the first N samples
    # have partial overlap coverage (stream warm-up, same as the reference's
    # real-time behavior), so score from there.
    m = min(len(mono), len(y))
    ref, got = mono[n:m], y[n:m]
    print(
        f"{args.infile} -> {args.outfile}: {len(y)} samples, "
        f"SNR {ct.snr_db(ref, got):.1f} dB (past the N-sample warm-up)"
    )
    for p in (args.ckpt, args.ckpt + ".out.npy"):
        if os.path.exists(p):
            os.remove(p)


if __name__ == "__main__":
    main()
