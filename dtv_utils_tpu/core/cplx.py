"""Complex-as-real-float32 representations and converters.

Complex values in the chains are explicit float32 re/im reals.  TWO
layouts serve different places:

  * **pair layout** [..., 2] (re, im interleaved in the trailing axis):
    bit-identical to the gr_complex / .cfile format every reference tool
    reads and writes (/root/reference/papr.c:100), so HOST I/O is a plain
    ``tofile``/``fromfile``.  Fine on device for SMALL or mid-fusion
    values.
  * **rail layout** [2, ...] (re rail, im rail): the DEVICE layout for
    long IQ streams and any materialized payload-sized buffer, with the
    long axis minor.  rails_to_np/rails_from_np convert at the host
    boundary.

All functions broadcast like their complex counterparts; dtype is float32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Two real arrays → pair array [..., 2]."""
    return jnp.stack([re, im], axis=-1)


def re(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., 0]


def im(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., 1]


def cmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise complex multiply of pair arrays."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def conj(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([x[..., 0], -x[..., 1]], axis=-1)


def abs2(x: jnp.ndarray) -> jnp.ndarray:
    """|x|^2 (real array, drops the pair axis)."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]


def scale(x: jnp.ndarray, s) -> jnp.ndarray:
    """Multiply by a real scalar."""
    return x * jnp.asarray(s, dtype=x.dtype)


def from_np(c: np.ndarray) -> np.ndarray:
    """NumPy complex array → float32 pair array [..., 2]."""
    c = np.ascontiguousarray(c, dtype=np.complex64)
    return c.view(np.float32).reshape(*c.shape, 2)


def to_np(x: np.ndarray) -> np.ndarray:
    """Float32 pair array [..., 2] → NumPy complex64 [...]."""
    x = np.ascontiguousarray(np.asarray(x), dtype=np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])


def rails_to_np(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Rail-major float32 array (size-2 re/im ``axis``) → complex64.

    Rail-major [2, n] is the DEVICE-side layout for long IQ streams; pairs
    remain the HOST format (.cfile interleaved IQ); this converter is the
    boundary."""
    x = np.asarray(x, dtype=np.float32)
    re_ = np.take(x, 0, axis=axis)
    im_ = np.take(x, 1, axis=axis)
    return (re_ + 1j * im_).astype(np.complex64)


def rails_from_np(c: np.ndarray, axis: int = 0) -> np.ndarray:
    """Complex array → rail-major float32 with re/im stacked at ``axis``."""
    c = np.ascontiguousarray(c, dtype=np.complex64)
    return np.stack([c.real, c.imag], axis=axis)
