"""Independent serial J.83B encoder used as a test oracle.

Explicit LFSRs / deques / per-group loops, sharing only constant tables with
dtv_utils_tpu.tx.j83b — catches vectorization and indexing bugs in the JAX
chain (spec-recall risks are shared and tracked in PARITY.md instead).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from dtv_utils_tpu.core.galois import GF128
from dtv_utils_tpu.tx import j83b as J


def rrc_polyphase(cells: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Float64 polyphase interpolate-by-2 from a zero history, one
    np.convolve per phase: out[2m + p] = Σ_k taps[2k + p] · cells[m − k]
    (the fast counterpart of SerialJ83b.rrc, for whole superblocks)."""
    n = len(cells)
    out = np.empty(2 * n, dtype=np.complex128)
    for p in range(2):
        out[p::2] = np.convolve(cells.astype(np.complex128),
                                taps[p::2].astype(np.float64))[:n]
    return out


class SerialJ83b:
    def __init__(self):
        self.branches = [deque([0] * (b * J.ILV_J)) for b in range(J.ILV_I)]
        self.sym_count = 0
        self.conv_a = [0, 0, 0, 0]
        self.conv_b = [0, 0, 0, 0]
        self.diff_q = 0
        self.rrc_hist = np.zeros(49, dtype=np.complex64)

    CRC8_TABLE = None

    def framing(self, ts: np.ndarray) -> np.ndarray:
        # CRC-8 long division, poly x^8+x^7+x^6+x^4+x^2+1, over 187 bytes;
        # table-driven (one step per byte) — independent of the bit-matrix.
        if SerialJ83b.CRC8_TABLE is None:
            tbl = np.zeros(256, dtype=np.uint8)
            for b in range(256):
                reg = b
                for _ in range(8):
                    fb = (reg >> 7) & 1
                    reg = (reg << 1) & 0xFF
                    if fb:
                        reg ^= 0b11010101   # x^7+x^6+x^4+x^2+1 low bits
                tbl[b] = reg
            SerialJ83b.CRC8_TABLE = tbl
        tbl = SerialJ83b.CRC8_TABLE
        out = ts.reshape(-1, 188).copy()
        for p in range(out.shape[0]):
            reg = 0
            for byte in out[p, 1:]:
                reg = int(tbl[reg ^ int(byte)])
            out[p, 0] = reg
        return out.reshape(-1)

    def pack7(self, data: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(data)
        return bits.reshape(-1, 7) @ (1 << np.arange(6, -1, -1))

    def rs(self, syms: np.ndarray) -> np.ndarray:
        enc = J._rs()
        blocks = syms.reshape(-1, J.RS_K)
        par = GF128.rs_encode_ref(blocks.astype(np.int64), enc.genpoly)
        cw126 = np.concatenate([blocks, par], axis=1)
        ext = np.bitwise_xor.reduce(cw126, axis=1)[:, None]
        return np.concatenate([cw126, ext], axis=1).reshape(-1)

    def interleave(self, syms: np.ndarray) -> np.ndarray:
        out = np.empty_like(syms)
        for i, s in enumerate(syms):
            b = self.sym_count % J.ILV_I
            if b == 0:
                out[i] = s
            else:
                q = self.branches[b]
                q.append(int(s))
                out[i] = q.popleft()
            self.sym_count += 1
        return out

    def randomize_and_sync(self, syms: np.ndarray) -> np.ndarray:
        rnd = J._randomizer_frame()
        frames = syms.reshape(-1, J.FRAME_SYMBOLS) ^ rnd[None, :]
        sync = np.zeros(J.FSYNC_BITS, dtype=np.uint8)
        for i in range(J.FSYNC_BITS):
            sync[i] = (J.FSYNC_WORD >> (J.FSYNC_BITS - 1 - i)) & 1
        out = []
        for f in frames:
            bits = np.unpackbits(f.astype(np.uint8)[:, None], axis=1)[:, 1:]
            out.append(bits.reshape(-1))
            out.append(sync)
        return np.concatenate(out)

    def _conv_step(self, reg: list[int], bit: int) -> tuple[int, int]:
        m = [bit] + reg
        x = m[0] ^ m[2] ^ m[4]
        y = m[0] ^ m[1] ^ m[2] ^ m[3] ^ m[4]
        reg[:] = m[:4]
        return x, y

    def trellis(self, bits: np.ndarray) -> np.ndarray:
        groups = bits.reshape(-1, 28)
        words = np.empty(groups.shape[0] * 5, dtype=np.int64)
        wi = 0
        for g in groups:
            a, b = g[0::2], g[1::2]
            ua, ca_in = a[:10], a[10:]
            ub, cb_in = b[:10], b[10:]
            ca, cb = [], []
            for i in range(4):
                x, y = self._conv_step(self.conv_a, int(ca_in[i]))
                if J.PUNCT_X[i]:
                    ca.append(x)
                if J.PUNCT_Y[i]:
                    ca.append(y)
            for i in range(4):
                x, y = self._conv_step(self.conv_b, int(cb_in[i]))
                if J.PUNCT_X[i]:
                    cb.append(x)
                if J.PUNCT_Y[i]:
                    cb.append(y)
            for j in range(5):
                w, u = int(ua[2 * j]), int(ua[2 * j + 1])
                z, v = int(ub[2 * j]), int(ub[2 * j + 1])
                q_in = (w << 1) | (w ^ z)
                self.diff_q = (self.diff_q + q_in) & 3
                W = self.diff_q >> 1
                Z = W ^ (self.diff_q & 1)
                # word layout pinned by the reference constellation's 90°
                # rotation structure: Gray quadrant on (b3, b0)
                words[wi] = ((u << 5) | (v << 4) | (W << 3)
                             | (ca[j] << 2) | (cb[j] << 1) | Z)
                wi += 1
        return words

    def rrc(self, cells: np.ndarray, taps: np.ndarray) -> np.ndarray:
        ext = np.concatenate([self.rrc_hist, cells])
        n = len(cells)
        out = np.empty(2 * n, dtype=np.complex64)
        for p in range(2):
            hp = taps[p::2]
            for m in range(n):
                acc = 0j
                for k in range(50):
                    acc += hp[k] * ext[49 + m - k]
                out[2 * m + p] = acc
        self.rrc_hist = ext[-49:]
        return out

    def modulate_symbols(self, ts: np.ndarray) -> np.ndarray:
        """Full chain up to constellation cells (RRC tested separately)."""
        x = self.framing(np.asarray(ts, dtype=np.uint8))
        s = self.pack7(x)
        cw = self.rs(s)
        il = self.interleave(cw)
        bits = self.randomize_and_sync(il)
        words = self.trellis(bits)
        return J.CONSTELLATION_64[words]
