"""Plan-based FFT API.

Reference: dsp/fft/api/fft_api.h (`FftPlanDesc`, `IFftPlan`, `MakeFftPlan`).
A "plan" here is a thin object over jitted closures specialized on
(nfft, scrub); XLA owns algorithm selection the way kissfft owned it in the
reference. Validation semantics match the kissfft adapter
(kissfft_adapter.cc:14-38): REAL domain needs even nfft, in_place raises,
strides >= 1. The reference's batch cap of 16 (fft_api.h:47) is lifted —
batching is what the device is for — and `max_batch_size()` reports the
lifted cap.

Shapes: natural inputs are `[..., nfft]` (real) / `[..., nfft]` (complex);
`forward`/`inverse` also accept the reference's flat strided layout via the
`*_strided` methods (flat element `b*nfft*stride + i*stride`,
kissfft_adapter.cc:96-121 pointer arithmetic).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.types import FftDomain, FftPlanDesc


class FftPlan:
    """Plan object (reference: `IFftPlan`, fft_api.h:26-48)."""

    def __init__(self, desc: FftPlanDesc) -> None:
        self.desc = desc
        self._nfft = desc.nfft
        self._scrub = desc.scrub

    # --- capability introspection (fft_api.h:46-48) ---

    def supports_batch(self) -> bool:
        return True

    def max_batch_size(self) -> int:
        return 1 << 30  # effectively unbounded (the reference caps at 16)

    @property
    def num_bins(self) -> int:
        return self.desc.num_bins

    # --- natural [..., nfft] API ---

    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """Real -> complex, [..., nfft] -> [..., nfft//2+1].

        Respects desc.backend (fft.dispatch: AUTO is jnp.fft, MATMUL the
        DFT-as-matmul bases); scrub applies first.
        """
        self._require(FftDomain.REAL)
        self._check_last(x, self._nfft)
        from . import dispatch as _dispatch
        from .xla_backend import scrub

        x = jnp.asarray(x, dtype=jnp.float32)
        if self._scrub:
            x = scrub(x)
        return _dispatch.rfft(x, self._nfft, self.desc.backend)

    def inverse(self, spec: jnp.ndarray) -> jnp.ndarray:
        """Complex -> real, [..., nfft//2+1] -> [..., nfft]; includes 1/nfft."""
        self._require(FftDomain.REAL)
        self._check_last(spec, self.num_bins)
        from . import dispatch as _dispatch
        from .xla_backend import scrub

        y = _dispatch.irfft(
            jnp.asarray(spec, dtype=jnp.complex64), self._nfft,
            self.desc.backend,
        )
        return scrub(y) if self._scrub else y

    def forward_complex(self, x: jnp.ndarray) -> jnp.ndarray:
        self._require(FftDomain.COMPLEX)
        self._check_last(x, self._nfft)
        from . import dispatch as _dispatch
        from .xla_backend import scrub

        x = jnp.asarray(x, dtype=jnp.complex64)
        if self._scrub:
            x = scrub(x)
        return _dispatch.fft_complex(x, self._nfft, self.desc.backend)

    def inverse_complex(self, spec: jnp.ndarray) -> jnp.ndarray:
        """Complex inverse; includes 1/nfft (reference scales by 1/nfft,
        kissfft_adapter.cc:222-246)."""
        self._require(FftDomain.COMPLEX)
        self._check_last(spec, self._nfft)
        from . import dispatch as _dispatch
        from .xla_backend import scrub

        y = _dispatch.ifft_complex(
            jnp.asarray(spec, dtype=jnp.complex64), self._nfft,
            self.desc.backend,
        )
        return scrub(y) if self._scrub else y

    # --- flat strided layout (reference batch/stride contract) ---

    def _destride(self, flat: jnp.ndarray, elem: int, stride: int) -> jnp.ndarray:
        flat = jnp.asarray(flat)
        need = self.desc.batch * elem * stride
        if flat.shape[-1] < need - (stride - 1):
            raise ValueError(
                f"flat input of length {flat.shape[-1]} too short for "
                f"batch={self.desc.batch}, n={elem}, stride={stride}"
            )
        taken = flat[..., : need - (stride - 1) : stride] if stride > 1 else flat[..., : need]
        return taken.reshape(*flat.shape[:-1], self.desc.batch, elem)

    def _restride(self, x: jnp.ndarray, stride: int) -> jnp.ndarray:
        """Deliberate contract delta vs the reference: the C++ adapter writes
        only the strided positions of a caller-owned buffer and leaves the
        gap elements untouched (kissfft_adapter.cc:96-121); a functional
        array program has no caller buffer to preserve, so the gaps here are
        ZERO-FILLED. Callers that interleave two strided streams must write
        both through `.at[::stride].set(...)` on one buffer instead of
        relying on gap preservation."""
        if stride == 1:
            return x.reshape(*x.shape[:-2], -1)
        b, n = x.shape[-2:]
        out = jnp.zeros((*x.shape[:-2], b * n * stride), dtype=x.dtype)
        return out.at[..., ::stride].set(x.reshape(*x.shape[:-2], b * n))

    def forward_strided(self, flat: jnp.ndarray) -> jnp.ndarray:
        """Reference-layout forward: flat strided real input ->
        flat strided complex bins (b*num_bins*stride_out layout)."""
        x = self._destride(flat, self._nfft, self.desc.stride_in)
        return self._restride(self.forward(x), self.desc.stride_out)

    def inverse_strided(self, flat: jnp.ndarray) -> jnp.ndarray:
        spec = self._destride(flat, self.num_bins, self.desc.stride_in)
        return self._restride(self.inverse(spec), self.desc.stride_out)

    # --- validation helpers ---

    def _require(self, domain: FftDomain) -> None:
        if self.desc.domain != domain:
            raise ValueError(
                f"plan domain is {self.desc.domain.value}; this method needs "
                f"{domain.value}"
            )

    @staticmethod
    def _check_last(x: jnp.ndarray, n: int) -> None:
        if x.shape[-1] != n:
            raise ValueError(f"last axis must be {n}, got {x.shape[-1]}")


def make_fft_plan(desc: FftPlanDesc) -> FftPlan:
    """Factory (reference: `MakeFftPlan`, fft_api.h:51)."""
    return FftPlan(desc)
