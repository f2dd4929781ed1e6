"""Unnormalized DFTs on float32 re/im rails and pairs, through ``jnp.fft``.

The reference chains lean on FFTW (``fft.fft_vcc(carriers, False, ...)``
at the reference dvbt-blade.py:187 — an *unnormalized inverse* FFT).
Here the transform is XLA's FFT on complex64 (cuFFT on the GPU).  The
chains keep IQ as float32 re/im rails (core/cplx.py), so the rails are
joined into complex64 for the transform and split again after it.

The unnormalized inverse is computed as conj(FFT(conj(x))): a sign flip on
each side of the forward transform, so no 1/n scale is applied and then
undone in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fft_ri(xr: jnp.ndarray, xi: jnp.ndarray, sign: int = -1
           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unnormalized DFT along the LAST axis of separate re/im rails.

    sign=-1: forward DFT.  sign=+1: inverse*n (the FFTW/`fft_vcc` reverse
    convention the reference chains are calibrated to).
    """
    if sign < 0:
        y = jnp.fft.fft(jax.lax.complex(xr, xi))
        return jnp.real(y), jnp.imag(y)
    y = jnp.fft.fft(jax.lax.complex(xr, -xi))
    return jnp.real(y), -jnp.imag(y)


def fft_pairs(x: jnp.ndarray, sign: int = -1) -> jnp.ndarray:
    """Unnormalized DFT along axis -2 of a pair array [..., n, 2].

    sign=-1: forward DFT.  sign=+1: inverse*n (divide by n for the
    mathematical inverse).
    """
    outr, outi = fft_ri(x[..., 0], x[..., 1], sign)
    return jnp.stack([outr, outi], axis=-1)


def fft_rails(x: jnp.ndarray, sign: int = -1) -> jnp.ndarray:
    """Unnormalized DFT along the last axis of a rail-major array
    [..., 2, n] (re at index 0 of axis -2, im at 1)."""
    outr, outi = fft_ri(x[..., 0, :], x[..., 1, :], sign)
    return jnp.stack([outr, outi], axis=-2)


def ifft_rails(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized inverse DFT on rails [..., 2, n] (see fft_pairs)."""
    return fft_rails(x, sign=+1)


def ifftshift_rails(x: jnp.ndarray) -> jnp.ndarray:
    """numpy.fft.ifftshift along the last axis of a rails array."""
    n = x.shape[-1]
    return jnp.roll(x, -(n // 2), axis=-1)


def ifft_pairs(x: jnp.ndarray) -> jnp.ndarray:
    """Unnormalized inverse DFT (multiply by 1/n for numpy.fft.ifft parity)."""
    return fft_pairs(x, sign=+1)


def ifftshift_pairs(x: jnp.ndarray) -> jnp.ndarray:
    """numpy.fft.ifftshift along axis -2 of a pair array."""
    n = x.shape[-2]
    return jnp.roll(x, -(n // 2), axis=-2)
