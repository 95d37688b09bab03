"""Headline benchmark: STFT -> iSTFT -> OLA round-trip throughput on one GPU.

Config per BASELINE.json: 60 s of 48 kHz mono, FFT=1024, hop=256, Hann,
centred, through `crlot_tpu.round_trip` (the route AUTO picks). One warm-up
call compiles; then the median and p90 of `--iters` calls, each ending in
`block_until_ready`. The round trip must reconstruct its input at
>= 60 dB SNR in the same run.

Baseline: the reference C++ pipeline measures 0.90 ms for 1 s @ 48 kHz mono
(N=1024, H=512) on Apple Silicon => ~53.3e6 samples/s (BASELINE.md).

    python bench.py [--seconds 60] [--iters 10] [--seed 0]

Prints ONE JSON line and exits non-zero when there is no GPU or the SNR
gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BASELINE_SAMPLES_PER_SEC = 48000 / 0.90e-3  # reference e2e: 0.90 ms / 1 s audio
METRIC = "stft_istft_ola_roundtrip_throughput_n1024_h256"
SNR_GATE_DB = 60.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from crlot_tpu.bench.device import (
        device_record,
        require_gpu,
        time_call,
        use_compile_cache,
    )
    from crlot_tpu.core.types import StftConfig
    from crlot_tpu.metrics import snr_db
    from crlot_tpu.pipeline import round_trip

    require_gpu()
    use_compile_cache()
    sr = 48000
    rng = np.random.default_rng(args.seed)
    x_np = rng.uniform(-0.5, 0.5, int(sr * args.seconds)).astype(np.float32)
    x = jnp.asarray(x_np)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    fn = jax.jit(lambda v: round_trip(v, cfg))
    t = time_call(fn, x, iters=args.iters)
    snr = snr_db(x_np, np.asarray(fn(x)))
    value = x.size / t["median_s"]
    record = {
        "metric": METRIC,
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / BASELINE_SAMPLES_PER_SEC,
        "median_s": t["median_s"],
        "p90_s": t["p90_s"],
        "iters": t["iters"],
        "samples": int(x.size),
        "snr_db": snr,
        "snr_gate_db": SNR_GATE_DB,
        "device": device_record(),
    }
    print(json.dumps(record))
    return 0 if snr >= SNR_GATE_DB else 1


if __name__ == "__main__":
    sys.exit(main())
