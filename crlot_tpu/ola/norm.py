"""COLA normalization builders.

Reference: dsp/ola/norm_builder.{h,cc} `build_norm_linear` — for every ring
position, the sum of window values from ALL frame placements k*hop covering
it, including negative k so wrap-around positions get full coverage
(norm_builder.cc:8-52). The builder stores the raw physical sum; the eps guard
happens at consumption (norm_builder.h:19).

Batched formulation (SURVEY.md §2.8): when the ring length is hop-aligned
(the accumulator guarantees this, OLAAccumulator.cc:249-258) the full-coverage
sum is periodic with period `hop`:

    norm[p] = sum_{j=0}^{ceil(N/H)-1} w[(p mod H) + j*H]

so the whole build is one reshape-sum-tile — a closed-form constant per
(window, N, H). A brute-force numpy oracle is kept for non-aligned rings and
for tests.
"""

from __future__ import annotations

import numpy as np


def build_norm_linear(
    window: np.ndarray, ring_len: int, frame_size: int, hop: int
) -> np.ndarray:
    """Full-coverage per-ring-position window sum, float32[ring_len].

    Matches the reference contract: every position's norm assumes full
    (steady-state, wrap-around) frame coverage. `window` may be the analysis
    window w (single-window pipelines, norm = sum w) or w^2 (analysis +
    synthesis pipelines, norm = sum w^2) — the builder just sums what it is
    given, like the reference.
    """
    w = np.asarray(window, dtype=np.float64)
    if w.shape != (frame_size,):
        raise ValueError(f"window shape {w.shape} != ({frame_size},)")
    if hop <= 0 or ring_len <= 0:
        raise ValueError("hop and ring_len must be > 0")
    if ring_len % hop != 0:
        # A non-hop-aligned ring has no well-defined steady-state coverage:
        # each wrap shifts the frame phase. The reference always hop-aligns
        # (OLAAccumulator.cc:249-258); we make the precondition explicit.
        raise ValueError(
            f"ring_len ({ring_len}) must be a multiple of hop ({hop})"
        )
    period = _periodic_norm(w, hop)
    return np.tile(period, ring_len // hop).astype(np.float32)


def _periodic_norm(w64: np.ndarray, hop: int) -> np.ndarray:
    """Closed-form period-`hop` sum: norm[p] = sum_j w[p + j*hop]."""
    n = len(w64)
    n_pad = -(-n // hop) * hop
    wp = np.zeros(n_pad, dtype=np.float64)
    wp[:n] = w64
    return wp.reshape(-1, hop).sum(axis=0)


def brute_force_norm(
    window: np.ndarray, ring_len: int, frame_size: int, hop: int
) -> np.ndarray:
    """O(K*N) test oracle over explicit placements k*hop (incl. negative k so
    position 0 gets full coverage), mirroring the reference's triple-loop
    oracle (tests/norm_builder_test.cc:13-45). Requires hop-aligned ring."""
    w64 = np.asarray(window, dtype=np.float64)
    n = frame_size
    if ring_len % hop != 0:
        raise ValueError("ring_len must be a multiple of hop")
    norm = np.zeros(ring_len, dtype=np.float64)
    k_min = -(-(n - 1) // hop)
    k_max = ring_len // hop
    for k in range(-k_min, k_max):
        for i in range(n):
            pos = k * hop + i
            if 0 <= pos < ring_len:
                norm[pos] += w64[i]
    return norm.astype(np.float32)


def edge_norm(
    window_contrib: np.ndarray, hop: int, num_frames: int, out_len: int
) -> np.ndarray:
    """Actual-coverage norm for OFFLINE reconstruction, float32[out_len]:
    norm[t] = sum over real frames k in [0, num_frames) of w[t - k*hop].

    Unlike `build_norm_linear` (steady-state/wrap coverage for the streaming
    ring), edge positions here are covered by fewer frames, so dividing by
    this norm reconstructs signal edges exactly.
    """
    w = np.asarray(window_contrib, dtype=np.float64)
    n = len(w)
    norm = np.zeros(out_len, dtype=np.float64)
    for k in range(num_frames):
        start = k * hop
        stop = min(start + n, out_len)
        if stop > start:
            norm[start:stop] += w[: stop - start]
    return norm.astype(np.float32)
