"""Time the round-trip routes, matmul precisions and overlap-add forms on
one GPU, beside the SNR each reaches. Its numbers decide
`fft.dispatch.blocked_route`, the `FftPrecision` -> `DotAlgorithmPreset`
mapping and the overlap-add form `istft` uses.

    python scripts/choose_routes.py [--out chiprun_out/choose_routes.json]
    python scripts/choose_routes.py --sweep   # the frame-size sweep only

Shapes: 60 s of 48 kHz mono at N=1024 (H=256 and H=512, centred Hann), and
BASELINE config 4's 64 channels x 60 s. `--sweep` times the cuFFT framed
route against the blocked route (BF16_BF16_F32_X3) for identity at
N in {256, 1024, 2048, 4096} with N/hop = 4, and at N=1024 with N/hop = 8,
on both shapes, in the order cuFFT, blocked, blocked, cuFFT. Each time is the median and p90 of
10 calls after one warm-up call, each call ending in `block_until_ready`.
A candidate that fails to compile is recorded with its error and the run
goes on; the script exits non-zero if any did.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from crlot_tpu.bench.device import (  # noqa: E402
    device_record,
    require_gpu,
    time_call,
    use_compile_cache,
)
from crlot_tpu.core.padding import pad_signal  # noqa: E402
from crlot_tpu.core.types import FftBackend, StftConfig  # noqa: E402
from crlot_tpu.fft import matmul_backend as mm  # noqa: E402
from crlot_tpu.frame.framing import frame_signal  # noqa: E402
from crlot_tpu.ola.fused import ola_normalized  # noqa: E402
from crlot_tpu.ola.reference import normalize, overlap_add  # noqa: E402
from crlot_tpu import pipeline, spectral  # noqa: E402

SR = 48000
SECONDS = 60
PRESETS = {
    "BF16_BF16_F32": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
    "BF16_BF16_F32_X3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "BF16_BF16_F32_X6": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6,
    "TF32_TF32_F32": jax.lax.DotAlgorithmPreset.TF32_TF32_F32,
    "TF32_TF32_F32_X3": jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
    "F32_F32_F32": jax.lax.DotAlgorithmPreset.F32_F32_F32,
    "lax.HIGH": jax.lax.Precision.HIGH,
    "lax.HIGHEST": jax.lax.Precision.HIGHEST,
    "default": None,
}


def snr_db(ref, out):
    ref = ref.astype(jnp.float32)
    num = jnp.sum(jnp.square(ref))
    den = jnp.sum(jnp.square(ref - out))
    return float(10.0 * jnp.log10(num / jnp.maximum(den, 1e-30)))


def fir_taps(n_taps=63, cutoff=0.25):
    t = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(2 * cutoff * t) * np.hamming(n_taps)
    return h / h.sum()


def norm_for(cfg, num_frames):
    full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    return full, jnp.asarray(pipeline._norm_np(cfg, num_frames, full))


def framed_route(cfg, x, ola, spectral_fn=None):
    """stft -> [fn] -> irfft -> overlap-add form `ola` -> crop."""
    spec = pipeline.stft(x, cfg)
    if spectral_fn is not None:
        spec = spectral_fn(spec)
    frames = jnp.fft.irfft(spec, n=cfg.frame_size, axis=-1)
    full, norm = norm_for(cfg, spec.shape[-2])
    pad = cfg.frame_spec.pad_amount
    return ola(frames, norm, cfg.hop_size, full, cfg.eps)[..., pad : pad + x.shape[-1]]


def ola_reference(frames, norm, hop, out_len, eps):
    return normalize(overlap_add(frames, hop, out_len), norm[:out_len], eps)


def blocked_rt(cfg, x, per_bin, precision):
    """pipeline.blocked_composed_round_trip with an explicit precision."""
    spec_ = cfg.frame_spec
    num_frames = spec_.num_frames(x.shape[-1])
    w64 = pipeline._window_f64(cfg)
    padded = pad_signal(x, spec_.pad_amount, spec_.pad_amount,
                        spec_.pad_mode, spec_.pad_value)
    norm_arr, full, edge, fold_ok = pipeline.blocked_norm_fold(cfg, num_frames)
    assert fold_ok
    out = mm.roundtrip_composed_blocked(
        padded, cfg.frame_size, cfg.hop_size, num_frames, w64, per_bin, None,
        precision=precision,
        group=mm.blocked_group_for(cfg.frame_size, cfg.hop_size),
        norm_f64=norm_arr, eps=cfg.eps,
    )
    pad = spec_.pad_amount
    return out[..., pad : pad + x.shape[-1]]


def tiled_route(cfg, x, precision, spectral_fn=None):
    """Framed symmetry-folded DFT matmuls (packed Re/Im planes) + OLA."""
    frames = frame_signal(x, cfg.frame_spec)
    w = jnp.asarray(pipeline._window_np(cfg))
    parts = mm.rfft_folded_tiled_parts(frames, cfg.frame_size, w, precision)
    if spectral_fn is not None:
        re, im = spectral_fn.packed(*mm.tiled_parts_to_packed(*parts))
        parts = mm.packed_to_tiled_parts(re, im, cfg.frame_size)
    out_frames = mm.irfft_folded_tiled_parts(*parts, cfg.frame_size, precision)
    full, norm = norm_for(cfg, frames.shape[-2])
    pad = cfg.frame_spec.pad_amount
    return ola_normalized(out_frames, norm, cfg.hop_size, full,
                          cfg.eps)[..., pad : pad + x.shape[-1]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/choose_routes.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="run only the frame-size sweep")
    args = ap.parse_args()
    require_gpu()
    cache = use_compile_cache()
    rec = {"device": device_record(), "jax": jax.__version__,
           "compile_cache": cache, "results": []}
    print(rec["device"]["name_power_limit"], flush=True)
    failures = 0

    def run(name, fn, x, ref=None, **meta):
        nonlocal failures
        entry = dict(name=name, **meta)
        try:
            jf = jax.jit(fn)
            t = time_call(jf, x)
            entry.update(t)
            y = jf(x)
            if ref is not None:
                entry["snr_db"] = snr_db(ref, y)
            entry["samples_per_s"] = x.size / t["median_s"]
        except Exception as e:  # noqa: BLE001 - record and go on
            failures += 1
            entry["error"] = f"{type(e).__name__}: {e}"[:2000]
            traceback.print_exc()
        print(json.dumps(entry), flush=True)
        rec["results"].append(entry)
        return entry

    rng = np.random.default_rng(args.seed)
    mono = jnp.asarray(rng.uniform(-0.5, 0.5, SR * SECONDS).astype(np.float32))
    mc = jnp.asarray(
        rng.uniform(-0.5, 0.5, (64, SR * SECONDS)).astype(np.float32))
    fir = spectral.per_bin_filter(spectral.fir_frequency_response(fir_taps(), 1024))
    h_fir = spectral.resolve_per_bin_response(fir, 1024)
    ones = np.ones(513)

    if args.sweep:
        for n, hop in ((256, 64), (1024, 256), (1024, 128), (2048, 512),
                       (4096, 1024)):
            cfg = StftConfig(n, hop, center=True)
            ones_n = np.ones(n // 2 + 1)
            routes = {
                "cufft_framed": lambda v: framed_route(cfg, v, ola_normalized),
                "blocked/BF16_BF16_F32_X3": lambda v: blocked_rt(
                    cfg, v, ones_n, PRESETS["BF16_BF16_F32_X3"]),
            }
            for shape, x in (("mono60s", mono), ("mc64x60s", mc)):
                for rname in ("cufft_framed", "blocked/BF16_BF16_F32_X3",
                              "blocked/BF16_BF16_F32_X3", "cufft_framed"):
                    run(f"sweep/{rname}", routes[rname], x, ref=x,
                        shape=shape, nfft=n, hop=hop)
        return finish(rec, args.out, failures)

    # 1. Overlap-add forms, alone and end to end (cuFFT framed route).
    for shape, x in (("mono60s", mono), ("mc64x60s", mc)):
        cfg = StftConfig(1024, 256, center=True, fft_backend=FftBackend.XLA)
        spec = jax.jit(lambda v: pipeline.stft(v, cfg))(x)
        frames = jax.jit(lambda s: jnp.fft.irfft(s, n=1024, axis=-1))(spec)
        del spec
        full, norm = norm_for(cfg, frames.shape[-2])
        want = jax.jit(lambda f: ola_reference(f, norm, 256, full, cfg.eps))(frames)
        for form, ola in (("a_dus_chain", ola_reference),
                          ("b_shifted_sum", ola_normalized)):
            e = run(f"ola_only/{form}", lambda f: ola(f, norm, 256, full, cfg.eps),
                    frames, shape=shape, hop=256)
            if "error" not in e:
                got = jax.jit(lambda f: ola(f, norm, 256, full, cfg.eps))(frames)
                e["bitexact_vs_reference"] = bool(jnp.array_equal(got, want))
                print(json.dumps({"bitexact": form, "v": e["bitexact_vs_reference"]}))
            run(f"e2e_framed/{form}", lambda v: framed_route(cfg, v, ola), x,
                ref=x, shape=shape, hop=256)
        del frames, want

    # 2. Routes x precision at H=256 and H=512 (identity, 60 s mono).
    for hop in (256, 512):
        cfg = StftConfig(1024, hop, center=True)
        run("route/cufft_framed", lambda v: framed_route(cfg, v, ola_normalized),
            mono, ref=mono, shape="mono60s", hop=hop)
        for pname, p in PRESETS.items():
            run(f"route/blocked/{pname}",
                lambda v: blocked_rt(cfg, v, ones, p), mono, ref=mono,
                shape="mono60s", hop=hop, precision=pname)
        for pname in ("BF16_BF16_F32_X3", "F32_F32_F32", "TF32_TF32_F32"):
            run(f"route/tiled_framed/{pname}",
                lambda v: tiled_route(cfg, v, PRESETS[pname]), mono, ref=mono,
                shape="mono60s", hop=hop, precision=pname)

    # 3. Config 4 shape: 64 ch x 60 s through the 63-tap FIR response; the
    # reference is the cuFFT route (both compute the same filter).
    cfg = StftConfig(1024, 256, center=True)
    ref = jax.jit(lambda v: framed_route(cfg, v, ola_normalized, fir))(mc)
    run("mc64_fir/cufft_framed",
        lambda v: framed_route(cfg, v, ola_normalized, fir), mc, ref=ref,
        shape="mc64x60s", hop=256)
    for pname in ("BF16_BF16_F32_X3", "BF16_BF16_F32_X6", "TF32_TF32_F32",
                  "F32_F32_F32"):
        run(f"mc64_fir/blocked/{pname}",
            lambda v: blocked_rt(cfg, v, h_fir, PRESETS[pname]), mc,
            ref=ref, shape="mc64x60s", hop=256, precision=pname)
    del ref

    # 4. The nonlinear spectral slot: complex cuFFT route vs packed planes.
    noise_mag = jnp.full((513,), 0.02, jnp.float32)
    for fname, fn in (
        ("noise_gate", spectral.noise_gate(-50.0)),
        ("spectral_subtraction", spectral.spectral_subtraction(noise_mag, 1.0, 0.05)),
    ):
        ref = jax.jit(lambda v: framed_route(cfg, v, ola_normalized, fn))(mono)
        run(f"nonlinear/{fname}/cufft_complex",
            lambda v: framed_route(cfg, v, ola_normalized, fn), mono, ref=ref,
            shape="mono60s", hop=256)
        for pname in ("BF16_BF16_F32_X3", "F32_F32_F32"):
            run(f"nonlinear/{fname}/tiled_packed/{pname}",
                lambda v: tiled_route(cfg, v, PRESETS[pname], fn), mono,
                ref=ref, shape="mono60s", hop=256, precision=pname)

    # 5. Forward transform alone (stft): cuFFT vs folded DFT matmul.
    for pname in ("cufft", "BF16_BF16_F32_X3", "F32_F32_F32"):
        backend = FftBackend.XLA if pname == "cufft" else FftBackend.MATMUL

        def fwd(v, backend=backend, pname=pname):
            frames = frame_signal(v, cfg.frame_spec)
            if backend == FftBackend.XLA:
                s = jnp.fft.rfft(frames * jnp.asarray(pipeline._window_np(cfg)), axis=-1)
                return jnp.abs(s)
            parts = mm.rfft_folded_tiled_parts(
                frames, 1024, jnp.asarray(pipeline._window_np(cfg)), PRESETS[pname])
            return parts[0]
        run(f"stft_only/{pname}", fwd, mono, shape="mono60s", hop=256)

    return finish(rec, args.out, failures)


def finish(rec, out, failures):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({"failures": failures, "out": out}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
