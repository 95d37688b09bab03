"""Core config types.

Frozen dataclasses mirroring the reference's POD config structs
(reference: dsp/ola/OLAAccumulator.h:15-29 `OLAConfig`,
dsp/fft/api/fft_api.h:10-23 `FftPlanDesc`, dsp/frame/framer.h:11-14
`BoundaryMode`, dsp/frame/FrameQueue.h:8-12 `PadMode`,
dsp/window/WindowLUT.h:14-31 window/normalization enums) — but validated at
construction and hashable so they can parameterize jitted closures.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class WindowType(enum.Enum):
    """Window function families (reference: dsp/window/WindowLUT.h:14-20).

    The reference declares BLACKMAN_HARRIS but throws "not yet implemented"
    (WindowLUT.cc:241-242); here it is implemented (4-term Blackman-Harris).
    """

    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"
    RECT = "rect"


class NormalizationType(enum.Enum):
    """Window normalization modes (reference: dsp/window/WindowLUT.h:25-31).

    - NONE: raw window values.
    - SUM_TO_ONE: w /= sum(w).
    - L2_NORM: w /= sqrt(sum(w^2)).
    - OLA_UNITY_GAIN: scale so that the steady-state overlap-add of the window
      at the given hop sums to one (requires hop; the reference falls back to
      L2 here, WindowLUT.cc:345-356 — we implement it properly when hop is
      given and fall back to L2 otherwise, matching the reference's observable
      behavior for hop-less calls).
    - OLA_SUM_WSQ: scale by sqrt(hop/sum(w^2)) so the squared-window overlap
      sums to one (reference: WindowLUT.cc:358-386 N/hop-scaled L2 variant).
    """

    NONE = "none"
    SUM_TO_ONE = "sum_to_one"
    L2_NORM = "l2_norm"
    OLA_UNITY_GAIN = "ola_unity_gain"
    OLA_SUM_WSQ = "ola_sum_wsq"


class PadMode(enum.Enum):
    """Centered-framing pad modes (reference: dsp/frame/FrameQueue.h:8-12).

    REFLECT is non-repeating "reflect101" (reference: dsp/frame/Indexing.h:18-33):
    [1,2,3,4] -> ...3,2,[1,2,3,4],3,2,...
    """

    CONSTANT = "constant"
    REFLECT = "reflect"
    EDGE = "edge"


class BoundaryMode(enum.Enum):
    """Streaming framer tail policy (reference: dsp/frame/framer.h:11-14)."""

    ZERO_PAD = "zero_pad"
    DROP = "drop"


class FftDomain(enum.Enum):
    """FFT plan domain (reference: dsp/fft/api/fft_api.h:10-14)."""

    REAL = "real"
    COMPLEX = "complex"


class FftPrecision(enum.Enum):
    """Matmul accumulation tier for the DFT and Toeplitz bases; on the GPU
    each maps to one explicit dot algorithm (fft.dispatch.to_lax_precision).

    HIGHEST = true f32 (F32_F32_F32).
    HIGH = three bf16 passes with f32 accumulation (BF16_BF16_F32_X3),
    about 113 dB identity round-trip SNR on the GPU, above 16-bit audio's
    ~96 dB and 53 dB above the reference's 60 dB gate.
    """

    HIGHEST = "highest"
    HIGH = "high"


class FftBackend(enum.Enum):
    """Which lowering the FFT uses (reference has one backend, kissfft,
    selected by a bazel config_setting `FFT_BACKEND=kissfft`,
    dsp/fft/BUILD.bazel:4-7; here backend choice is a config enum per
    SURVEY.md §5 'Config / flag system').

    XLA = jnp.fft (any N, any device; cuFFT on the GPU). MATMUL = DFT as
    matrix products (N <= 4096; Cooley-Tukey matmuls above), and the
    blocked hop-block Toeplitz round trip. AUTO: see
    `fft.dispatch.blocked_route`.
    """

    AUTO = "auto"
    XLA = "xla"
    MATMUL = "matmul"


@dataclass(frozen=True)
class FrameSpec:
    """Framing geometry (reference: dsp/frame/FrameQueue.cc ctor args +
    dsp/frame/framer.cc:15-35 `set_params` validation)."""

    frame_size: int
    hop_size: int
    center: bool = False
    pad_mode: PadMode = PadMode.CONSTANT
    pad_value: float = 0.0

    def __post_init__(self) -> None:
        if self.frame_size <= 0:
            raise ValueError(f"frame_size must be > 0, got {self.frame_size}")
        if self.hop_size <= 0:
            raise ValueError(f"hop_size must be > 0, got {self.hop_size}")

    @property
    def pad_amount(self) -> int:
        """Each-side pad for center mode (reference: FrameQueue.cc:68-97)."""
        return self.frame_size // 2 if self.center else 0

    @property
    def tail(self) -> int:
        """Unconsumed tail per frame step (reference: FrameQueue.cc:99-115)."""
        return max(self.frame_size - self.hop_size, 0)

    def num_frames(self, signal_len: int) -> int:
        """Frame-count law: max n with n*hop + tail <= padded_len
        (reference: dsp/frame/FrameQueue.cc:99-115)."""
        padded = signal_len + 2 * self.pad_amount
        if padded < self.frame_size:
            return 0
        return (padded - self.tail) // self.hop_size


@dataclass(frozen=True)
class FftPlanDesc:
    """FFT plan descriptor (reference: dsp/fft/api/fft_api.h:16-23).

    Contract carried over from the kissfft adapter
    (dsp/fft/backends/kissfft/kissfft_adapter.cc:14-38):
      - REAL domain requires even nfft,
      - in_place is unsupported,
      - batch >= 1 and strides >= 1.
    The reference caps batch at 16 (fft_api.h:47); on an accelerator
    batching is the whole point, so the cap is lifted (max_batch_size()
    reports it).
    """

    domain: FftDomain
    nfft: int
    in_place: bool = False
    batch: int = 1
    stride_in: int = 1
    stride_out: int = 1
    scrub: bool = True  # NaN/Inf->0 + denormal flush (kissfft_adapter.cc:96-121)
    backend: FftBackend = FftBackend.AUTO

    def __post_init__(self) -> None:
        if self.nfft <= 0:
            raise ValueError(f"nfft must be > 0, got {self.nfft}")
        if self.domain == FftDomain.REAL and self.nfft % 2 != 0:
            raise ValueError(f"REAL domain requires even nfft, got {self.nfft}")
        if self.in_place:
            raise ValueError("in_place transforms are not supported")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.stride_in < 1 or self.stride_out < 1:
            raise ValueError("strides must be >= 1")

    @property
    def num_bins(self) -> int:
        """Output bins for the REAL forward transform (n/2+1)."""
        return self.nfft // 2 + 1


@dataclass(frozen=True)
class OLAConfig:
    """Overlap-add accumulator config (reference: dsp/ola/OLAAccumulator.h:15-29).

    `ring_margin_hops` generalizes the reference's hard-coded "+20 hops"
    real-time safety margin (OLAAccumulator.cc:249-258).
    """

    sample_rate: int
    frame_size: int
    hop_size: int
    channels: int = 1
    eps: float = 1e-8
    apply_window_inside: bool = True
    ring_margin_hops: int = 20

    def __post_init__(self) -> None:
        if self.sample_rate <= 0:
            raise ValueError(f"sample_rate must be > 0, got {self.sample_rate}")
        if self.frame_size <= 0:
            raise ValueError(f"frame_size must be > 0, got {self.frame_size}")
        if self.hop_size <= 0:
            raise ValueError(f"hop_size must be > 0, got {self.hop_size}")
        if self.hop_size > self.frame_size:
            raise ValueError(
                f"hop_size ({self.hop_size}) must be <= frame_size "
                f"({self.frame_size})"
            )
        if self.channels <= 0:
            raise ValueError(f"channels must be > 0, got {self.channels}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")

    @property
    def overlap_count(self) -> int:
        """Max frames covering one sample: ceil(frame/hop)."""
        return -(-self.frame_size // self.hop_size)

    @property
    def ring_len(self) -> int:
        """Hop-aligned ring length: (ceil(N/H) + margin) * H
        (reference: OLAAccumulator.cc:249-258)."""
        return (self.overlap_count + self.ring_margin_hops) * self.hop_size


@dataclass(frozen=True)
class StftConfig:
    """End-to-end STFT/iSTFT pipeline config: framing + window + FFT + OLA.

    Single-window discipline (SURVEY.md §7 'hard parts'): the pipeline owns
    windowing. The analysis window is applied exactly once before the FFT, and
    the OLA normalization divides by the matching COLA sum (sum of w when no
    synthesis window, sum of w^2 when `synthesis_window=True`). This makes the
    reference's double-window bug (docs/PHASE0_AUDIT.md BLK-01,
    bench/e2e_benchmark.cc:154 + :61) unrepresentable.
    """

    frame_size: int
    hop_size: int
    window: WindowType = WindowType.HANN
    periodic: bool = True
    synthesis_window: bool = False
    center: bool = False
    pad_mode: PadMode = PadMode.REFLECT
    eps: float = 1e-8
    fft_backend: FftBackend = FftBackend.AUTO
    fft_precision: FftPrecision = FftPrecision.HIGH

    def __post_init__(self) -> None:
        if self.frame_size <= 0 or self.frame_size % 2 != 0:
            raise ValueError(
                f"frame_size must be positive and even, got {self.frame_size}"
            )
        if self.hop_size <= 0 or self.hop_size > self.frame_size:
            raise ValueError(
                f"hop_size must be in [1, frame_size], got {self.hop_size}"
            )

    @property
    def frame_spec(self) -> FrameSpec:
        return FrameSpec(
            frame_size=self.frame_size,
            hop_size=self.hop_size,
            center=self.center,
            pad_mode=self.pad_mode,
        )

    @property
    def num_bins(self) -> int:
        return self.frame_size // 2 + 1
