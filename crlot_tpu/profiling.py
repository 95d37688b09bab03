"""Tracing, roofline accounting, and NaN-debug mode.

Reference analogs (SURVEY.md §5): google_benchmark custom reporters +
`scripts/run_all.sh` env capture -> `trace()` (jax.profiler) and
`environment_info()`; the SIGFPE/NaN posture -> `nan_debug()`; the in-code
µs/roofline targets -> `roofline_samples_per_sec()` for the >=90%-of-roofline
gate in BASELINE.json.
"""

from __future__ import annotations

import contextlib
import json
import platform
import subprocess
from dataclasses import dataclass
from typing import Iterator, Optional

import jax

# Published dense peaks per device, keyed by the exact `device_kind` JAX
# reports: (hbm_bytes_per_sec, bf16_flops, tf32_flops, f32_flops).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense
# (without sparsity), at the 700 W power limit: 3.35 TB/s HBM3, 989 TFLOP/s
# bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 outside the tensor cores. The
# PCIe part (2.0 TB/s, other rates) reports another device_kind and is not
# matched.
_DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 989e12, 495e12, 67e12),
}


def device_specs(kind: Optional[str] = None):
    """(hbm_bytes_per_sec, bf16, tf32, f32 flops) of `kind` (default: JAX's
    first device). A device that is not in the table raises KeyError."""
    kind = kind or jax.devices()[0].device_kind
    if kind not in _DEVICE_SPECS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(_DEVICE_SPECS)}"
        )
    return _DEVICE_SPECS[kind]


@dataclass(frozen=True)
class PipelineTraffic:
    """HBM bytes and FLOPs per INPUT SAMPLE for a round-trip config."""

    bytes_per_sample: float
    flops_per_sample: float


def roundtrip_traffic(
    frame_size: int, hop: int, matmul_fft: bool = True, folded: bool = True,
    formulation: str = "framed", group: int = 2,
) -> PipelineTraffic:
    """Traffic model of the round-trip, per INPUT sample.

    `formulation="framed"` (default): ideal-fusion model of
    frame->window->rFFT->irFFT->OLA->norm — read x once, write+read the
    [F, N] frame matrix in both directions (overlap factor R = N/H),
    spectrum write+read, write y once. FLOPs: the symmetry-folded DFT
    matmul is N*(N/2+1) MACs per frame per direction
    (fft/matmul_backend.py::rfft_folded_packed), the direct basis
    2*N*(N+2) MACs; FFT is 5*N*log2(N) per direction.

    `formulation="spectral"`: the framed NONLINEAR per-bin path (packed
    Re/Im planes through an arbitrary elementwise spectral fn — the
    `.packed` route of the sharded and streaming matmul paths). Same folded-DFT FLOPs as
    "framed" plus the fn's elementwise work; bytes add one spectrum
    read+write pass for the fn (XLA cannot fuse an elementwise stage
    INTO a dot operand, so the fn's output is a materialized [F, K]
    pair). This model is why nonlinear processing cannot reach the
    blocked identity/EQ rate: identity/EQ COMPOSE into the kernel at
    design time (halving MACs and shedding the frame matrix), while a
    nonlinear fn forces the spectrum through HBM. The OLA-folded
    hop-block synthesis alternative is strictly worse: folding OLA into
    the inverse basis breaks the even/odd fold (R*2K = ~4x MACs/sample
    vs the folded inverse) for only ~25% byte savings — a modeled
    negative result (docs/DESIGN.md r4).

    `formulation="blocked"`: the hop-block Toeplitz round-trip
    (matmul_backend.roundtrip_composed_blocked — the GPU identity/EQ path
    for 256 <= N <= 1024 at 4 <= N/hop <= 8). Per output sample the kernel row spans
    (R + G - 2)*hop + N input samples (R = N/hop), i.e. 2048 MACs at the
    headline config vs the framed formulation's ~4100, with NO frame
    matrix: the mg = ceil(kernel_height / (G*hop)) matmul terms each read
    the signal once and write a partial, and the final fused
    add+normalize reads the partials + norm and writes the output.

    Both models are APPROXIMATE by construction: XLA's fusion can
    eliminate modeled passes (e.g. folding elementwise stages into matmul
    operands), so a well-fused pipeline can measure slightly ABOVE this
    "roofline" — treat roofline_pct near or over 100 as "the modeled
    passes are fully fused", not as a physical violation.
    """
    if formulation == "blocked":
        r = frame_size // hop
        gh = group * hop
        height = (r + group - 2) * hop + frame_size
        mg = -(-height // gh)
        flops = 2.0 * height + 6  # + normalize epilogue
        b = (
            4.0 * mg      # signal read per matmul term
            + 4.0 * mg    # per-term partial write
            + 4.0 * mg    # final fused add reads the partials
            + 4.0         # norm read
            + 4.0         # output write
        )
        return PipelineTraffic(bytes_per_sample=b, flops_per_sample=flops)
    import math

    r = frame_size / hop
    bytes_frames = 2 * 4 * r  # write + read, forward
    bytes_spec = 2 * 4 * r * ((frame_size // 2 + 1) * 2 / frame_size)
    bytes_out_frames = 2 * 4 * r
    b = 4 + bytes_frames + bytes_spec + bytes_out_frames + 4 + 4
    if formulation == "spectral":
        b += bytes_spec  # the fn's output planes: one more write + read
    if matmul_fft and folded and frame_size % 2 == 0:
        # 2 FLOP per MAC x half-size [Re | Im] bases, two directions.
        flops_per_frame = 2 * frame_size * (frame_size // 2 + 1) * 2
    elif matmul_fft:
        flops_per_frame = 2 * frame_size * (frame_size + 2) * 2
    else:
        flops_per_frame = 2 * 5 * frame_size * math.log2(frame_size)
    f = flops_per_frame / hop + 10  # + window/ola/normalize elementwise
    return PipelineTraffic(bytes_per_sample=b, flops_per_sample=f)


def roofline_samples_per_sec(
    frame_size: int, hop: int, matmul_fft: bool = True,
    device_kind: Optional[str] = None, precision: str = "high",
    folded: bool = True, formulation: str = "framed", group: int = 2,
) -> dict:
    """Speed-of-light samples/s for the round-trip on this device: the min of
    the HBM-bandwidth bound and the compute bound, with both reported.

    precision: 'high' (FftPrecision.HIGH = three bf16 passes per f32
    matmul, compute peak bf16/3) or 'highest' (FftPrecision.HIGHEST = true
    f32, the f32 peak).
    """
    hbm, bf16, _tf32, f32 = device_specs(device_kind)
    t = roundtrip_traffic(frame_size, hop, matmul_fft, folded,
                          formulation, group)
    compute_peak = bf16 / 3.0 if precision == "high" else f32
    bw_bound = hbm / t.bytes_per_sample
    compute_bound = compute_peak / t.flops_per_sample
    return {
        "bandwidth_bound_samples_per_sec": bw_bound,
        "compute_bound_samples_per_sec": compute_bound,
        "roofline_samples_per_sec": min(bw_bound, compute_bound),
        "bytes_per_sample": t.bytes_per_sample,
        "flops_per_sample": t.flops_per_sample,
        "precision": precision,
        "formulation": formulation,
    }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace scope; open with xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def nan_debug() -> Iterator[None]:
    """Scope that makes NaN production raise immediately (the debugging
    counterpart of the pipeline's finite-scrub contract)."""
    prev = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def environment_info() -> dict:
    """Build/CPU/git capture (reference: scripts/run_all.sh:54-72)."""
    try:
        git = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        git = "unknown"
    dev = jax.devices()[0]
    return {
        "git": git,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "device_kind": dev.device_kind,
        "num_devices": len(jax.devices()),
    }


if __name__ == "__main__":
    print(json.dumps(environment_info(), indent=1))
