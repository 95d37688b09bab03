"""Drive the WAV -> STFT -> iSTFT -> OLA main path on a GPU at real size.

    python chip_smoke.py [--seed 0] [--out out/chip_smoke]
    python chip_smoke.py --devices 4      # the sharded paths on four GPUs

Every input is generated from `--seed`. Each phase runs the public entry
points at BASELINE.json's sizes, compares against a plain reference
(float64 numpy or scipy, or the one-shot program a streamer must equal
bit for bit) and prints each gate value beside its limit, its compile
seconds, `compiled.memory_analysis()` and the device's peak bytes in use.
A failed gate raises and the script exits non-zero. The last line of
standard output is one JSON object naming the device.

With `--devices 4` only the multi-device phases run: BASELINE config 4 on
a (4, 1) channel mesh and config 5's shape on a (1, 4) time mesh, each
against the same program on one card, bit for bit (config 4's FIR: to the
one card's accuracy, see `phase_channel_mesh`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

SR = 48000
N, HOP = 1024, 256
CHUNK = 49152  # ~1 s at 48 kHz, a whole number of 512-sample hop pairs


class GateFailed(AssertionError):
    pass


def gate(name: str, value: float, limit: float, at_least: bool = True) -> float:
    ok = value >= limit if at_least else value <= limit
    print(f"  gate {name}: {value!r} {'>=' if at_least else '<='} {limit!r} "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise GateFailed(f"{name}: {value!r} vs limit {limit!r}")
    return value


def identical(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    same = got.shape == want.shape and np.array_equal(got, want)
    diff = (float(np.max(np.abs(got.astype(np.float64) - want)))
            if got.shape == want.shape else float("nan"))
    print(f"  gate {name}: bit-identical={same} (max |diff| {diff!r})",
          flush=True)
    if not same:
        raise GateFailed(f"{name}: not bit-identical, max |diff| {diff!r}")


def rounding_ulps(name: str, got, exact, scale, limit: float) -> float:
    """Gate max |got - exact| in ULPs of the float32 operand scale: one half
    ULP per rounded float32 operation (XLA may fuse a multiply-add)."""
    spacing = np.spacing(np.asarray(scale, np.float32)).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - exact) / spacing
    return gate(f"{name} max error in ULPs of the operand scale",
                float(np.max(err)), limit, at_least=False)


def compiled(name: str, fn, *args):
    """jit-compile fn for args, print compile seconds and memory analysis."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = exe.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    info = {f: getattr(mem, f, None) for f in fields} if mem is not None else None
    print(f"  compile {name}: {dt:.2f} s, memory_analysis {info}", flush=True)
    return exe


def peak_bytes() -> None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}", flush=True)


# ---------------------------------------------------------------------------
# plain float64 references
# ---------------------------------------------------------------------------


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def np_stft(x: np.ndarray, n: int, hop: int, center: bool) -> np.ndarray:
    x = np.asarray(x, np.float64)
    pad = n // 2 if center else 0
    if pad:
        x = np.pad(x, (pad, pad), mode="reflect")
    nf = (len(x) - n) // hop + 1
    idx = np.arange(nf)[:, None] * hop + np.arange(n)[None, :]
    return np.fft.rfft(x[idx] * hann(n), axis=-1)


def np_round_trip(x, n, hop, response=None, center=True, eps=1e-8):
    """float64 STFT -> response -> iSTFT -> OLA / COLA norm, periodic Hann,
    reflect padding when centred (hop must divide n)."""
    spec = np_stft(x, n, hop, center)
    if response is not None:
        spec = spec * response
    frames = np.fft.irfft(spec, n=n, axis=-1)
    nf, r_count = frames.shape[0], n // hop
    out = np.zeros((nf + r_count - 1, hop))
    norm = np.zeros((nf + r_count - 1, hop))
    w = hann(n).reshape(r_count, hop)
    for r in range(r_count):
        out[r : r + nf] += frames[:, r * hop : (r + 1) * hop]
        norm[r : r + nf] += w[r]
    y = out.reshape(-1) / np.maximum(norm.reshape(-1), eps)
    pad = n // 2 if center else 0
    return y[pad : pad + len(x)]


def fir_taps(n_taps: int = 63, cutoff: float = 0.25) -> np.ndarray:
    t = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(2 * cutoff * t) * np.hamming(n_taps)
    return h / h.sum()


def test_signal(rng, shape, sr: int) -> np.ndarray:
    """Tones plus noise, peak below full scale."""
    t = np.arange(shape[-1]) / sr
    tones = sum(a * np.sin(2 * np.pi * f * t)
                for f, a in ((220.0, 0.3), (1375.5, 0.15), (6021.0, 0.05)))
    x = tones + 0.1 * rng.standard_normal(shape)
    return (0.9 * x / np.max(np.abs(x))).astype(np.float32)


# ---------------------------------------------------------------------------
# phases (one card)
# ---------------------------------------------------------------------------


def phase_headline(rng, out_dir: str, seconds: float = 60.0,
                   hops=(256, 512)) -> dict:
    """WAV (24-bit) -> read_wav -> round_trip -> write_wav -> read_wav."""
    import jax

    import crlot_tpu as ct
    from crlot_tpu.io import native

    x = test_signal(rng, (int(SR * seconds),), SR)
    src = os.path.join(out_dir, "headline_in.wav")
    ct.write_wav(src, x, SR, bits=24)
    data, sr = ct.read_wav(src)
    codec = "python"
    if native.native_available():
        nat, _ = native.read_wav_native(src)
        identical("native codec == python codec", nat, data)
        codec = "python (native C++ codec built and agrees)"
    print(f"  wav codec: {codec}", flush=True)
    res = {}
    for hop in hops:
        cfg = ct.StftConfig(frame_size=N, hop_size=hop, center=True)
        exe = compiled(f"round_trip h{hop}", lambda v: ct.round_trip(v, cfg),
                       jax.numpy.asarray(data[0]))
        y = np.asarray(exe(jax.numpy.asarray(data[0])))
        dst = os.path.join(out_dir, f"headline_out_h{hop}.wav")
        ct.write_wav(dst, y, sr, bits=24)
        back, _ = ct.read_wav(dst)
        res[f"snr_db_h{hop}"] = gate(f"wav round-trip SNR dB (N={N}, H={hop})",
                                     ct.snr_db(data[0], back[0]), 60.0)
    peak_bytes()
    return res


def phase_eq_fir(rng, seconds: float = 60.0, snr_gate_db: float = 90.0) -> dict:
    """band_gain and a 63-tap FIR through round_trip vs float64 numpy."""
    import jax.numpy as jnp

    import crlot_tpu as ct
    from crlot_tpu import spectral

    x = test_signal(rng, (int(SR * seconds),), SR)
    cfg = ct.StftConfig(frame_size=N, hop_size=HOP, center=True)
    freqs = np.arange(N // 2 + 1) * (SR / N)
    edges, gains = [250.0, 2000.0, 8000.0], [0.5, 1.0, 1.5, 0.25]
    taps = fir_taps()
    fir64 = np.fft.rfft(np.pad(taps, (0, N - len(taps))))
    cases = {
        "band_gain": (spectral.band_gain(edges, gains, SR, N),
                      np.asarray(gains)[np.searchsorted(edges, freqs)]),
        "fir63": (spectral.per_bin_filter(
            spectral.fir_frequency_response(taps, N)), fir64),
    }
    res = {}
    for name, (fn, resp64) in cases.items():
        exe = compiled(name, lambda v: ct.round_trip(v, cfg, fn), jnp.asarray(x))
        y = np.asarray(exe(jnp.asarray(x)))
        want = np_round_trip(x, N, HOP, resp64)
        res[name] = gate(f"{name} vs float64 numpy SNR dB (FftPrecision."
                         f"{cfg.fft_precision.name})", ct.snr_db(want, y),
                         snr_gate_db)
    peak_bytes()
    return res


def phase_multichannel(rng, channels: int = 64, seconds: float = 60.0,
                       snr_gate_db: float = 90.0) -> dict:
    """BASELINE config 4 on one card: 64 ch x 60 s through the FIR."""
    import jax.numpy as jnp

    import crlot_tpu as ct
    from crlot_tpu import spectral

    x = test_signal(rng, (channels, int(SR * seconds)), SR)
    print(f"  input bytes: {x.nbytes}", flush=True)
    cfg = ct.StftConfig(frame_size=N, hop_size=HOP, center=True)
    taps = fir_taps()
    fn = spectral.per_bin_filter(spectral.fir_frequency_response(taps, N))
    fir64 = np.fft.rfft(np.pad(taps, (0, N - len(taps))))
    exe = compiled("mc round_trip fir", lambda v: ct.round_trip(v, cfg, fn),
                   jnp.asarray(x))
    y = np.asarray(exe(jnp.asarray(x)))
    sig = noise = 0.0
    worst = math.inf
    for c in range(channels):
        want = np_round_trip(x[c], N, HOP, fir64)
        d = want - y[c]
        sig += float(np.sum(want * want))
        noise += float(np.sum(d * d))
        worst = min(worst, ct.snr_db(want, y[c]))
    res = {
        "snr_db": gate("all channels vs float64 numpy SNR dB",
                       10 * math.log10(sig / noise), snr_gate_db),
        "worst_channel_snr_db": gate("worst channel SNR dB", worst, snr_gate_db),
    }
    peak_bytes()
    return res


def phase_resample(rng, minutes: float = 10.0, snr_gate_db: float = 100.0) -> dict:
    """44.1 kHz -> 48 kHz -> 16 kHz via ct.resample and resampled_stft,
    against scipy.signal.resample_poly in float64 with the same filters."""
    import jax.numpy as jnp
    from scipy import signal as sps

    import crlot_tpu as ct
    from crlot_tpu.pipeline import resampled_stft
    from crlot_tpu.resample.polyphase import design_lowpass

    x = test_signal(rng, (int(44100 * 60 * minutes),), 44100)
    exe48 = compiled("resample 44.1k->48k",
                     lambda v: ct.resample(v, 44100, 48000), jnp.asarray(x))
    y48 = exe48(jnp.asarray(x))
    exe16 = compiled("resample 48k->16k",
                     lambda v: ct.resample(v, 48000, 16000), y48)
    y16 = np.asarray(exe16(y48))
    want48 = sps.resample_poly(x.astype(np.float64), 160, 147,
                               window=design_lowpass(160, 147) / 160)
    want16 = sps.resample_poly(want48, 1, 3, window=design_lowpass(1, 3))
    cfg = ct.StftConfig(frame_size=512, hop_size=128)
    exe_s = compiled("resampled_stft 48k->16k",
                     lambda v: resampled_stft(v, 48000, 16000, cfg), y48)
    spec = np.asarray(exe_s(y48))
    spec64 = np_stft(want16, 512, 128, center=False)
    res = {
        "snr_db_48k": gate("44.1k->48k vs scipy SNR dB",
                           ct.snr_db(want48, np.asarray(y48)), snr_gate_db),
        "snr_db_16k": gate("44.1k->48k->16k vs scipy SNR dB",
                           ct.snr_db(want16, y16), snr_gate_db),
        "stft_snr_db": gate(
            "resampled_stft vs scipy chain + numpy STFT SNR dB",
            ct.snr_db(np.stack([spec64.real, spec64.imag]),
                      np.stack([spec.real, spec.imag])), snr_gate_db),
    }
    peak_bytes()
    return res


def phase_nonlinear(rng, seconds: float = 60.0, snr_gate_db: float = 60.0) -> dict:
    """noise_gate and spectral_subtraction through round_trip against the
    same fns applied by their `.packed` form on split Re/Im planes."""
    import jax
    import jax.numpy as jnp

    import crlot_tpu as ct
    from crlot_tpu import spectral
    from crlot_tpu.pipeline import istft, stft

    x = test_signal(rng, (int(SR * seconds),), SR)
    cfg = ct.StftConfig(frame_size=N, hop_size=HOP, center=True)
    fns = {
        "noise_gate": spectral.noise_gate(-50.0),
        "spectral_subtraction": spectral.spectral_subtraction(
            jnp.full((N // 2 + 1,), 0.02, jnp.float32), 1.0, 0.05),
    }

    def packed_route(v, fn):
        s = stft(v, cfg)
        re, im = fn.packed(s.real, s.imag)
        return istft(jax.lax.complex(re, im), cfg, length=v.shape[-1])

    res = {}
    for name, fn in fns.items():
        exe = compiled(name, lambda v: ct.round_trip(v, cfg, fn), jnp.asarray(x))
        y = np.asarray(exe(jnp.asarray(x)))
        want = np.asarray(jax.jit(lambda v: packed_route(v, fn))(jnp.asarray(x)))
        assert np.isfinite(y).all()
        res[name] = gate(f"{name}: complex vs packed SNR dB",
                         ct.snr_db(want, y), snr_gate_db)
    peak_bytes()
    return res


def phase_streaming(rng, chunks: int = 59, chunk: int = CHUNK,
                    backend: str = "AUTO") -> dict:
    """Chunked streams of stereo audio, each bit-identical to its one-shot,
    with one checkpoint/resume through a file."""
    import jax
    import jax.numpy as jnp

    import crlot_tpu as ct
    from crlot_tpu.pipeline import blocked_composed_round_trip
    from crlot_tpu.streaming_pipeline import (
        BlockedChunkStreamer,
        blocked_stream_supported,
        streaming_round_trip,
        streaming_round_trip_blocks,
    )

    cfg = ct.StftConfig(frame_size=N, hop_size=HOP, center=False,
                        fft_backend=ct.FftBackend[backend])
    x = test_signal(rng, (2, chunks * chunk), SR)
    res = {}

    # Scan streamer: frames cut per chunk, the OLA tail carried across.
    block_frames = 64
    per_chunk = chunk // HOP
    assert per_chunk % block_frames == 0
    for c in range(2):
        once, _ = streaming_round_trip(x[c], cfg, block_frames)
        carry, outs = None, []
        n_frames = (x.shape[1] - (N - HOP)) // HOP // block_frames * block_frames
        for k in range(0, n_frames, per_chunk):
            f = min(per_chunk, n_frames - k)
            idx = (k + np.arange(f))[:, None] * HOP + np.arange(N)[None, :]
            frames = jnp.asarray(x[c][idx].reshape(-1, block_frames, N))
            y, carry = streaming_round_trip_blocks(
                frames, cfg, block_frames, carry_tail=carry, return_carry=True)
            outs.append(np.asarray(y))
        identical(f"scan streamer ch{c}: {len(outs)} chunks == one-shot",
                  np.concatenate(outs), once)
    res["scan_chunks"] = len(outs)

    if not blocked_stream_supported(cfg, chunk):
        print("  blocked chunk streamer: not the route for this backend",
              flush=True)
        return res
    # The one-shot is one jitted program, as users run it: op-by-op
    # dispatch fuses nothing and rounds the edge patches differently.
    per_bin = np.ones(N // 2 + 1)
    once = np.asarray(jax.jit(
        lambda v: blocked_composed_round_trip(v, cfg, per_bin))(jnp.asarray(x)))
    st = BlockedChunkStreamer(cfg)
    outs = []
    ckpt_at = chunks // 2
    with tempfile.TemporaryDirectory() as d:
        for k in range(chunks):
            y = st.feed(x[:, k * chunk : (k + 1) * chunk])
            if y is not None:
                outs.append(y)
            if k == ckpt_at:
                path = os.path.join(d, "stream.npz")
                s = st.state()
                np.savez(path, prev=s["prev"], lctx=s["lctx"],
                         first=s["first"], s=s["s"])
                st = BlockedChunkStreamer(cfg)
                with np.load(path) as z:
                    st.load_state({"prev": z["prev"], "lctx": z["lctx"],
                                   "first": bool(z["first"]), "s": int(z["s"])})
        outs.append(st.finish())
    identical(f"blocked chunk streamer: {chunks} chunks, resumed at chunk "
              f"{ckpt_at}, == one-shot", np.concatenate(outs, axis=-1), once)
    res["blocked_chunks"] = chunks
    peak_bytes()
    return res


def phase_features(rng, seconds: float = 30.0, snr_gate_db: float = 80.0) -> dict:
    """mel_spectrogram and mfcc at librosa's defaults against float64 numpy;
    sosfilt against scipy."""
    import jax.numpy as jnp
    from scipy import signal as sps

    import crlot_tpu as ct
    from crlot_tpu.features import _dct_ii_ortho

    sr, n_fft, hop, n_mels = 22050, 2048, 512, 128
    x = test_signal(rng, (int(sr * seconds),), sr)
    cfg = ct.StftConfig(frame_size=n_fft, hop_size=hop, center=True)
    fb = ct.mel_filterbank(sr, n_fft, n_mels).astype(np.float64)
    p64 = np.abs(np_stft(x, n_fft, hop, center=True)) ** 2
    mel64 = p64 @ fb.T
    mfcc64 = 10 * np.log10(np.maximum(mel64, 1e-10)) @ _dct_ii_ortho(
        20, n_mels).astype(np.float64).T
    exe_m = compiled("mel_spectrogram",
                     lambda v: ct.mel_spectrogram(v, cfg, sr, n_mels),
                     jnp.asarray(x))
    exe_c = compiled("mfcc",
                     lambda v: ct.mfcc(v, cfg, sr, 20, n_mels), jnp.asarray(x))
    mel = np.asarray(exe_m(jnp.asarray(x)))
    mf = np.asarray(exe_c(jnp.asarray(x)))
    sos = ct.butter_sos(6, 1000.0, "lowpass", fs=sr)
    exe_i = compiled("sosfilt", lambda v: ct.sosfilt(sos, v), jnp.asarray(x))
    yi = np.asarray(exe_i(jnp.asarray(x)))
    res = {
        "mel_snr_db": gate("mel power vs float64 numpy SNR dB",
                           ct.snr_db(mel64, mel), snr_gate_db),
        "mfcc_snr_db": gate("mfcc vs float64 numpy SNR dB",
                            ct.snr_db(mfcc64, mf), snr_gate_db),
        "sosfilt_snr_db": gate("sosfilt vs scipy float64 SNR dB",
                               ct.snr_db(sps.sosfilt(sos, x.astype(np.float64)),
                                         yi), 70.0),
    }
    peak_bytes()
    return res


def phase_kernels(rng, seconds: float = 60.0, channels: int = 64) -> dict:
    """The retained OLA kernels at the headline and config-4 widths: the
    one-fusion overlap-add against the DUS-chain reference, bit for bit,
    and the flat-array kernels against numpy."""
    import jax
    import jax.numpy as jnp

    from crlot_tpu.ola import kernels as K
    from crlot_tpu.ola.fused import ola_normalized
    from crlot_tpu.ola.norm import edge_norm
    from crlot_tpu.ola.reference import normalize, overlap_add

    nf = int(SR * seconds) // HOP + 1
    full = (nf - 1) * HOP + N
    norm = jnp.asarray(edge_norm(hann(N), HOP, nf, full).astype(np.float32))
    res = {}
    for shape in ((nf, N), (channels, nf, N)):
        frames = jnp.asarray(rng.standard_normal(shape, dtype=np.float32))
        exe = compiled(f"ola_normalized {shape}",
                       lambda f, nm: ola_normalized(f, nm, HOP, full),
                       frames, norm)
        got = exe(frames, norm)
        want = normalize(overlap_add(frames, HOP, full), norm)
        identical(f"one-fusion OLA {shape} == DUS-chain reference", got, want)
        del frames, got, want
    n = int(SR * seconds)
    a, b, w = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    prod = 0.5 * b.astype(np.float64)
    res["axpy_ulps"] = rounding_ulps(
        "axpy vs numpy", K.axpy(a, b, 0.5), a + prod,
        np.abs(a) + np.abs(prod), 1.0)
    prod = prod * w
    res["axpy_windowed_ulps"] = rounding_ulps(
        "axpy_windowed vs numpy", K.axpy_windowed(a, b, w, 0.5), a + prod,
        np.abs(a) + np.abs(prod), 1.5)
    norm2 = np.abs(w) + np.float32(0.5)
    y, cleared = K.normalize_and_clear(a, norm2, 1e-8)
    exact = a.astype(np.float64) / norm2
    # On the GPU XLA compiles the f32 divide to PTX div.full.f32 (read from
    # the compiled PTX), which is not correctly rounded: the PTX ISA states
    # at most 2 ULP, and an H100 read 1.857, 1.970 and 2.050 ULP of the
    # quotient's float32 spacing on three inputs of this size. The CPU's
    # divide is correctly rounded (0.5 ULP, tests/test_kernels.py).
    res["normalize_ulps"] = rounding_ulps(
        "normalize_and_clear vs numpy", y, exact, np.abs(exact),
        2.5 if jax.devices()[0].platform == "gpu" else 0.5)
    assert not np.asarray(cleared).any()
    peak_bytes()
    return res


# ---------------------------------------------------------------------------
# phases (four cards)
# ---------------------------------------------------------------------------


def phase_channel_mesh(rng, devices, channels: int = 64,
                       seconds: float = 60.0) -> dict:
    """Config 4 on a (4, 1) channel mesh vs the same program on one card.

    Identity must match bit for bit. The 63-tap FIR cannot: on the GPU the
    bits of a GEMM row depend on how many rows the library is handed (16
    channels per card here, 64 on one card), in every dot algorithm. So
    the FIR is held to the one card's accuracy against float64 numpy over
    the interior (center=False: the first and last N - H samples divide by
    near-zero COLA norms), and its largest difference from one card is
    printed."""
    import jax.numpy as jnp

    import crlot_tpu as ct
    from crlot_tpu import spectral
    from crlot_tpu.distributed import make_mesh, sharded_round_trip

    x = test_signal(rng, (channels, int(SR * seconds)), SR)
    xj = jnp.asarray(x)
    cfg = ct.StftConfig(frame_size=N, hop_size=HOP)
    taps = fir_taps()
    fir = spectral.per_bin_filter(spectral.fir_frequency_response(taps, N))
    meshes = {"1 card": make_mesh(1, 1, devices[:1]),
              f"({len(devices)}, 1) mesh": make_mesh(len(devices), 1, devices)}
    outs = {}
    for resp, fn in (("identity", None), ("fir63", fir)):
        for label, mesh in meshes.items():
            exe = compiled(f"config 4 {resp} {label}",
                           lambda v: sharded_round_trip(v, cfg, mesh, fn), xj)
            outs[resp, label] = np.asarray(exe(xj))
    one, many = meshes
    identical(f"config 4 identity: {many} vs {one}",
              outs["identity", many], outs["identity", one])
    a, b = outs["fir63", one], outs["fir63", many]
    max_diff = float(np.max(np.abs(a.astype(np.float64) - b)))
    print(f"  config 4 fir63: max |diff| {many} vs {one}: {max_diff!r}",
          flush=True)
    fir64 = np.fft.rfft(np.pad(taps, (0, N - len(taps))))
    inner = slice(N - HOP, x.shape[1] - (N - HOP))
    sig = noise_one = noise_many = 0.0
    for c in range(channels):
        want = np_round_trip(x[c], N, HOP, fir64, center=False)[inner]
        sig += float(np.sum(want * want))
        noise_one += float(np.sum(np.square(want - a[c, inner])))
        noise_many += float(np.sum(np.square(want - b[c, inner])))
    snr_one = 10 * math.log10(sig / noise_one)
    snr_many = gate(f"config 4 fir63: {many} interior SNR vs float64 numpy, "
                    f"dB (one card {snr_one!r} less 0.01)",
                    10 * math.log10(sig / noise_many), snr_one - 0.01)
    peak_bytes()
    return {"channels": channels, "samples": int(x.shape[1]),
            "fir63_max_diff": max_diff, "fir63_snr_db_one_card": snr_one,
            "fir63_snr_db_mesh": snr_many}


def phase_time_mesh_stream(rng, devices, channels: int = 128,
                           chunks: int = 20, chunk_per_card: int = CHUNK) -> dict:
    """Config 5's shape on a (1, 4) time mesh: a chunked ShardedStreamer
    (~1 s per card per chunk, halo ppermute) with one mid-stream
    checkpoint/resume, against the same stream on one card."""
    import crlot_tpu as ct
    from crlot_tpu.distributed import ShardedStreamer, make_mesh

    n_dev = len(devices)
    chunk = chunk_per_card * n_dev
    cfg = ct.StftConfig(frame_size=N, hop_size=HOP)
    x = test_signal(rng, (channels, chunks * chunk), SR)

    def run(mesh):
        st = ShardedStreamer(cfg, mesh)
        outs = []
        with tempfile.TemporaryDirectory() as d:
            for k in range(chunks):
                y = st.feed(x[:, k * chunk : (k + 1) * chunk])
                if y is not None:
                    outs.append(y)
                if k == chunks // 2:
                    s = st.state()
                    path = os.path.join(d, "ckpt.npz")
                    np.savez(path, prev=s["prev"], tail=s["tail"],
                             first=s["first"], s=s["s"])
                    st = ShardedStreamer(cfg, mesh)
                    with np.load(path) as z:
                        st.load_state({"prev": z["prev"], "tail": z["tail"],
                                       "first": bool(z["first"]),
                                       "s": int(z["s"])})
            outs.append(st.finish())
        return np.concatenate(outs, axis=1), st._mode is not None

    t0 = time.perf_counter()
    one, blocked1 = run(make_mesh(1, 1, devices[:1]))
    t1 = time.perf_counter()
    many, blocked4 = run(make_mesh(1, n_dev, devices))
    t2 = time.perf_counter()
    print(f"  stream walls (compile included): 1 card {t1 - t0:.1f} s, "
          f"{n_dev} cards {t2 - t1:.1f} s; blocked formulation "
          f"{blocked1}/{blocked4}", flush=True)
    inner = slice(N - HOP, x.shape[1] - (N - HOP))
    for label, y in (("1 card", one), (f"(1, {n_dev}) mesh", many)):
        print(f"  config 5 {label}: interior SNR vs input "
              f"{ct.snr_db(x[:, inner], y[:, inner])!r} dB", flush=True)
    identical(f"config 5 stream: {chunks} chunks of {chunk} x {channels} ch, "
              f"resumed at chunk {chunks // 2}, (1, {n_dev}) mesh vs 1 card",
              many, one)
    peak_bytes()
    return {"channels": channels, "chunks": chunks, "chunk": chunk}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--out", default=os.path.join("out", "chip_smoke"))
    args = ap.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX's first device is {platform!r}",
              file=sys.stderr)
        return 2
    from crlot_tpu.bench.device import gpu_name_and_power_limit, use_compile_cache

    print(gpu_name_and_power_limit(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"compile cache: {use_compile_cache()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    results = {}
    t_all = time.perf_counter()
    if args.devices == 4:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            print(f"chip_smoke: --devices 4 needs 4 GPUs, have {len(devices)}",
                  file=sys.stderr)
            return 2
        phases = [("config4_channel_mesh",
                   lambda: phase_channel_mesh(rng, devices)),
                  ("config5_time_mesh_stream",
                   lambda: phase_time_mesh_stream(rng, devices))]
    else:
        phases = [
            ("1_headline_wav", lambda: phase_headline(rng, args.out)),
            ("2_eq_fir", lambda: phase_eq_fir(rng)),
            ("3_multichannel", lambda: phase_multichannel(rng)),
            ("4_resample", lambda: phase_resample(rng)),
            ("5_nonlinear", lambda: phase_nonlinear(rng)),
            ("6_streaming", lambda: phase_streaming(rng)),
            ("7_features_iir", lambda: phase_features(rng)),
            ("8_kernels", lambda: phase_kernels(rng)),
        ]
    for name, fn in phases:
        print(f"phase {name}", flush=True)
        t0 = time.perf_counter()
        results[name] = fn()
        print(f"  phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(args.out, f"results_{args.devices}dev.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
