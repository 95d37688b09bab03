"""Dynamic time warping on feature sequences (min-plus scan formulation).

Aligns two feature matrices X `[N, d]`, Y `[M, d]` with the classic DTW
recurrence over steps {(1,0), (0,1), (1,1)}:

    D[i, j] = C[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

Parallel formulation: the in-row dependency D[i, j-1] makes a naive row
sweep sequential in j, but the recurrence d[j] = min(a[j], d[j-1] + c[j])
(with a[j] = c[j] + min(up[j], up-left[j]) folding in the previous row) is
a MIN-PLUS LINEAR RECURRENCE: the update functions f_j(x) = min(a_j,
x + c_j) compose associatively as (a2, c2) o (a1, c1) = (min(a2, a1 + c2),
c1 + c2). Each row is therefore one `lax.associative_scan` (log-depth on
the VPU), and rows advance under a single `lax.scan` — no O(N*M)
sequential chain, no data-dependent control flow.

The accumulated matrix is computed in-jit; the warping path (a
data-dependent-length index list) is backtraced on the host from that
matrix, following the repo's mask-then-host convention (pitch.py,
segment.py).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["dtw_cost", "dtw", "dtw_path"]

# Plain numpy scalar: jnp.float32(...) at module level would create a
# device array at import time and initialize the backend — which breaks
# jax.distributed.initialize() in multihost children (test_multihost.py).
_BIG = np.float32(3.0e38)


def _as_frames(a) -> "jnp.ndarray":
    """Coerce to a [N, d] frame matrix: 1-D length-N input is N
    scalar-feature frames [N, 1] (atleast_2d would silently make it ONE
    N-dim frame, yielding a meaningless 1x1 alignment); rank > 2 raises."""
    a = jnp.asarray(a, jnp.float32)
    if a.ndim == 1:
        return a[:, None]
    if a.ndim != 2:
        raise ValueError(f"expected [N, d] or 1-D [N] series, got {a.shape}")
    return a


@partial(jax.jit, static_argnames=("metric",))
def dtw_cost(
    x: jnp.ndarray, y: jnp.ndarray, metric: str = "euclidean"
) -> jnp.ndarray:
    """Pairwise frame-distance matrix `[N, M]` between X `[N, d]` and
    Y `[M, d]`. `euclidean` expands |x-y|^2 = |x|^2 + |y|^2 - 2<x, y>
    so the cross term is one matmul (f32 cancellation leaves an
    ~1e-3 absolute floor on near-zero distances — irrelevant at DTW's
    scale); `cosine` is 1 - normalized dot.

    A 1-D input of length N is treated as N scalar-feature frames
    (reshaped to [N, 1]); higher-rank inputs raise."""
    x = _as_frames(x)
    y = _as_frames(y)
    if metric == "euclidean":
        sq = (
            jnp.sum(jnp.square(x), axis=1)[:, None]
            + jnp.sum(jnp.square(y), axis=1)[None, :]
            - 2.0 * jnp.matmul(x, y.T, precision=jax.lax.Precision.HIGHEST)
        )
        return jnp.sqrt(jnp.maximum(sq, 0.0))
    if metric == "cosine":
        xn = x / jnp.maximum(
            jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        yn = y / jnp.maximum(
            jnp.linalg.norm(y, axis=1, keepdims=True), 1e-12)
        return 1.0 - jnp.matmul(xn, yn.T, precision=jax.lax.Precision.HIGHEST)
    raise ValueError(f"unknown metric {metric!r}")


def _minplus_row(carry_prev: jnp.ndarray, c_row: jnp.ndarray) -> jnp.ndarray:
    """One DTW row given the previous accumulated row: the min-plus scan
    d[j] = min(a[j], d[j-1] + c[j]), a[j] = c[j] + min(up[j], upleft[j])."""
    upleft = jnp.concatenate([jnp.array([_BIG]), carry_prev[:-1]])
    a = c_row + jnp.minimum(carry_prev, upleft)

    def combine(left, right):
        a_l, c_l = left
        a_r, c_r = right
        return jnp.minimum(a_r, a_l + c_r), c_l + c_r

    a_s, _ = jax.lax.associative_scan(combine, (a, c_row))
    return a_s


@partial(jax.jit, static_argnames=("metric",))
def dtw(
    x: jnp.ndarray, y: jnp.ndarray, metric: str = "euclidean"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """DTW of X `[N, d]` against Y `[M, d]` -> `(total_cost, acc)` where
    `acc` is the `[N, M]` accumulated-cost matrix (acc[-1, -1] ==
    total_cost). Feed `acc` to `dtw_path` for the warping path."""
    c = dtw_cost(x, y, metric=metric)
    row0 = jnp.cumsum(c[0])  # only (0,1) steps exist in row 0

    def step(prev, c_row):
        nxt = _minplus_row(prev, c_row)
        return nxt, nxt

    _, rows = jax.lax.scan(step, row0, c[1:])
    acc = jnp.concatenate([row0[None, :], rows], axis=0)
    return acc[-1, -1], acc


def dtw_path(acc) -> List[Tuple[int, int]]:
    """Backtrace the optimal warping path from an accumulated-cost matrix
    (host-side, data-dependent length): returns [(0, 0), ..., (N-1, M-1)]
    in ascending order, stepping through the minimal predecessor each
    time (ties prefer the diagonal)."""
    a = np.asarray(acc, np.float64)
    i, j = a.shape[0] - 1, a.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            cands = (a[i - 1, j - 1], a[i - 1, j], a[i, j - 1])
            k = int(np.argmin(cands))  # diagonal wins ties (index 0)
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    return path[::-1]
