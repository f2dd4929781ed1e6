"""Interleavers as static gathers.

The reference realizes interleaving with byte-shuffling delay lines
(GNU Radio convolutional_interleaver at /root/reference/dvbt-blade.py:181)
and per-bit index loops.  Here every interleaver is a precomputed
index array + one gather, which XLA fuses with its neighbours.

The Forney convolutional interleaver is the only one with cross-block state;
its state is equivalent to the last ``(I-1)*I*M`` bytes of *input* stream, so
a block formulation is: gather from [carry_tail || block].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def forney_carry_len(I: int, M: int) -> int:
    return (I - 1) * I * M


def forney_gather_indices(I: int, M: int, n: int) -> np.ndarray:
    """Indices into [carry(len C) || block(len n)] producing the interleaved
    block.  Composite-stream identity: output position k (branch b = k mod I)
    carries the input byte from position k - b*I*M; negative positions come
    from the carry tail.  Requires n % I == 0 (packet-aligned blocks keep the
    commutator phase at 0, true for 204-byte packets with I=12)."""
    assert n % I == 0
    C = forney_carry_len(I, M)
    k = np.arange(n, dtype=np.int64)
    src = k - (k % I) * I * M          # position in the input stream
    return src + C                     # shift into the concatenated buffer


def forney_interleave(block: jnp.ndarray, carry: jnp.ndarray,
                      idx: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Apply the Forney interleaver to one block.

    block: uint8 [n]; carry: uint8 [C] (zeros at stream start);
    idx: precomputed forney_gather_indices.  Returns (out [n], new_carry [C]).
    """
    C = carry.shape[0]
    ext = jnp.concatenate([carry, block])
    out = ext[idx]
    new_carry = ext[-C:]
    return out, new_carry
