"""An accelerator DSP framework in JAX, run on NVIDIA GPUs.

Built from scratch with the capabilities of crlotwhite/crlot-dsp (C++17
audio-DSP toolkit): framing, windows with COLA normalization, plan-based FFT,
overlap-add reconstruction, polyphase resampling, WAV I/O — as batched array
programs, with shard_map channel/time-block parallelism and halo exchange.
See SURVEY.md.
"""

from .core.types import (
    BoundaryMode,
    FftBackend,
    FftDomain,
    FftPlanDesc,
    FftPrecision,
    FrameSpec,
    NormalizationType,
    OLAConfig,
    PadMode,
    StftConfig,
    WindowType,
)
from .fft.api import FftPlan, make_fft_plan
from .frame.framing import frame_signal, frame_windowed, num_frames
from .frame.streaming import Framer
from .io.wav import WavReader, WavWriter, read_wav, write_wav
from .metrics import PeakMeter, snr_db, xcorr_delay_ms
from .ola.reference import overlap_add, overlap_add_normalized
from .pipeline import istft, round_trip, stft
from .window.windows import get_window

from .resample.polyphase import resample, resample_chunked
from .convolve import convolve
from .features import (
    chroma,
    chroma_cqt,
    chroma_filterbank,
    cqt_filterbank,
    delta,
    envelope,
    frame_rms,
    instantaneous_frequency,
    lpc,
    lpc_envelope_db,
    mel_filterbank,
    mel_spectrogram,
    mel_to_audio,
    mel_to_linear,
    mfcc,
    mfcc_to_mel,
    pcen,
    amplitude_to_db,
    db_to_amplitude,
    db_to_power,
    magphase,
    power_to_db,
    pseudo_cqt,
    real_cepstrum,
    spectral_bandwidth,
    spectral_centroid,
    spectral_contrast,
    spectral_flatness,
    spectral_rolloff,
    tonnetz,
    zero_crossing_rate,
)
from .align import dtw, dtw_cost, dtw_path
from .segment import (
    activity_mask,
    frames_to_time,
    split_silence,
    time_to_frames,
    trim_silence,
)
from .effects import (
    deemphasis,
    mu_compress,
    mu_expand,
    mu_law_decode,
    mu_law_encode,
    preemphasis,
)
from .griffinlim import griffin_lim, stft_magnitude
from .hpss import harmonic, hpss, hpss_masks, percussive
from .pitch import detect_onsets, onset_strength, tempo, tempogram, yin_f0
from .iir import (
    a_weighting_sos,
    butter_sos,
    c_weighting_sos,
    lfilter,
    sosfilt,
    sosfilt_zi,
    sosfiltfilt,
)
from .psd import coherence, welch_freqs, welch_psd
from .streaming_pipeline import process_wav_file, streaming_round_trip
from .wire import I16BlockedStreamer, i16_round_trip
from .vocoder import pitch_shift, time_stretch

from . import (  # noqa: E402,F401
    checkpoint,
    core,
    distributed,
    fft,
    frame,
    io,
    metrics,
    ola,
    profiling,
    resample,
    spectral,
    window,
)

__version__ = "0.1.0"
