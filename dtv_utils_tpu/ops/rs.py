"""Reed-Solomon encoding as a GF(2) bit-matrix multiply.

The reference encodes RS(204,188) byte-serially through a GF(256) LFSR
(GNU Radio block instantiated at /root/reference/dvbt-blade.py:180 with
(2, 8, 0x11d, 255, 239, 8, 51, ...) — i.e. RS(255,239) t=8 shortened by 51).
RS codes are linear over GF(2), so the parity of a packet is a binary matrix
product: ``parity_bits = msg_bits @ M mod 2`` with M precomputed once on the
host by pushing unit vectors through the reference LFSR.  A whole superframe
of packets becomes ONE int8 matmul [n_pkt, 1504] x [1504, 128] that XLA tiles
onto the 128x128 systolic array — no sequential state anywhere.

Shortening costs nothing: the 51 leading zero symbols of RS(255,239) leave
the division register at zero, so the 188-byte encoder is exact.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core.galois import GF, GF256, gf2_matmul, rs_parity_bitmatrix


class RsBitEncoder:
    """Systematic RS encoder over GF(2^m) via a GF(2) parity bit-matrix.

    Parameters mirror the classic (n, k, t) with an optional shortening:
    the *transmitted* codeword is ``k_sym`` data symbols + ``nroots`` parity.
    """

    def __init__(self, gf: GF, k_sym: int, nroots: int,
                 first_root: int = 0, root_step: int = 1):
        self.gf = gf
        self.k_sym = k_sym
        self.nroots = nroots
        self.m = gf.m
        self.genpoly = gf.rs_generator_poly(nroots, first_root, root_step)
        # [k_sym*m, nroots*m] uint8 — built once on host.  Kept as NumPy:
        # encoder instances are cached across jit traces, so they must never
        # hold jax values (first construction may happen under a trace).
        self.M = rs_parity_bitmatrix(gf, k_sym, self.genpoly)

    def parity_bits(self, msg_bits: jnp.ndarray) -> jnp.ndarray:
        """msg_bits [..., k_sym*m] in {0,1} → parity bits [..., nroots*m]."""
        return gf2_matmul(msg_bits, self.M.astype(np.int8))

    def encode_bytes(self, msg: jnp.ndarray) -> jnp.ndarray:
        """uint8 msg [..., k_sym] (m==8 only) → codeword [..., k_sym+nroots]."""
        assert self.m == 8
        mbits = bitops.bytes_to_bits(msg)
        pbits = self.parity_bits(mbits)
        parity = bitops.bits_to_bytes(pbits)
        return jnp.concatenate([msg, parity], axis=-1)

    # ---- host-side oracle (independent byte-serial path, for tests) ----
    def encode_bytes_ref(self, msg: np.ndarray) -> np.ndarray:
        par = self.gf.rs_encode_ref(np.asarray(msg, dtype=np.int64),
                                    self.genpoly)
        return np.concatenate(
            [np.asarray(msg, dtype=np.int64), par], axis=-1).astype(np.uint8)


@functools.cache
def DVBT_RS() -> RsBitEncoder:
    """The DVB-T outer code: shortened RS(204,188), t=8, GF(256)/0x11d
    (EN 300 744 §4.3.2; reference parameterization dvbt-blade.py:180)."""
    return RsBitEncoder(GF256, k_sym=188, nroots=16)
