"""ITU-T J.83 Annex B (SCTE 07) 64-QAM cable modulator.

Re-expresses the reference chain /root/reference/qam-blade.py:50-79
(transport framing → 7-bit symbolization → RS(128,122) over GF(128) →
(I=128, J=4) convolutional interleaver → GF(128) randomizer → frame sync →
trellis-coded modulation → 64-QAM map → RRC interpolate-by-2) as one jit
array program over a "superblock" of 188 FEC frames — the smallest unit on
which MPEG packets (188 bytes), 7-bit symbols, RS codewords (122 symbols),
FEC frames (60 RS blocks + 42-bit FSYNC) and 28-bit trellis groups all
align (6405 packets / 1,806,210 channel symbols).

Rate identity (validates the structure against README:79's 26.970352 Mbps):
  5056941 sym/s · 6 b/sym · 14/15 (TCM) · 8960/8967 (FSYNC) · 122/128 (RS)
  = 26.970352 Mbps exactly.

Sequential elements are vectorized as array programs:
  * both rate-1/2 binary convolutional coders (G=(25,37) octal, 16-state)
    are shifted-XOR filters over the whole substream;
  * the 90°-invariance differential precoder is a prefix-XOR
    (jax.lax.associative_scan);
  * RS parity is a GF(2) bit-matrix matmul over 7-bit symbol bitplanes;
  * interleaver / puncture / demux are static gathers.

Items marked PARITY-RISK carry constants reconstructed from the standard
without a golden reference available in this environment; see PARITY.md.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core import cplx
from dtv_utils_tpu.core.config import J83bConfig
from dtv_utils_tpu.core.galois import GF128
from dtv_utils_tpu.ops.rs import RsBitEncoder

# ---------------------------------------------------------------------------
# Frame constants (64-QAM mode)
# ---------------------------------------------------------------------------
RS_N, RS_K = 128, 122
BLOCKS_PER_FRAME = 60                  # RS blocks per FEC frame
FRAME_SYMBOLS = BLOCKS_PER_FRAME * RS_N          # 7680 7-bit symbols
FSYNC_BITS = 42
FRAME_BITS = FRAME_SYMBOLS * 7 + FSYNC_BITS      # 53802
FRAMES_PER_SUPERBLOCK = 188
PACKETS_PER_SUPERBLOCK = 6405          # = 188 frames of TS bytes
TRELLIS_GROUP_IN, TRELLIS_GROUP_OUT = 28, 30

# 42-bit frame sync trailer, 64-QAM mode: a 38-bit unique sync pattern
# followed by the 4-bit control word in the trailing field — 6 ⇒
# (I=128, J=4), README:88-104 — so a receiver reads the interleaver mode
# from the trailer (SCTE 07 §5.4 structure).  PARITY-RISK: the sync
# pattern bits are from recall; placement/extraction is invariant-tested
# (tests/test_j83b_invariants.py).
FSYNC_SYNC_PATTERN = 0x2CA2C92CA >> 4      # 38 bits
CONTROL_WORD = 6
FSYNC_WORD = (FSYNC_SYNC_PATTERN << 4) | CONTROL_WORD  # 42 bits

# interleaver: branch b delays b*J symbols, commutated over I branches
ILV_I, ILV_J = 128, 4

# trellis binary convolutional generators, octal 25 / 37 (K=5, 16-state)
G1_TAPS = (0, 2, 4)        # 25oct = 10101b
G2_TAPS = (0, 1, 2, 3, 4)  # 37oct = 11111b
# rate-4/5 puncture: 4 input steps → 5 kept of 8 (PARITY-RISK: pattern
# X:1001, Y:1110 reconstructed from recall of SCTE 07 §5.5)
PUNCT_X = (1, 0, 0, 1)
PUNCT_Y = (1, 1, 1, 0)

# 64-QAM constellation LUT, exactly the literal the reference passes to
# chunks_to_symbols (qam-blade.py:57); index = 6-bit trellis output word
CONSTELLATION_64 = np.array([
    1+1j, 1-1j, 1-3j, -3-1j, -3+1j, 1+3j, -3-3j, -3+3j,
    -1+1j, -1-1j, 3+1j, -1+3j, -1-3j, 3-1j, 3-3j, 3+3j,
    5+1j, 1-5j, 1-7j, -7-1j, -3+5j, 5+3j, -7-3j, -3+7j,
    -1+5j, -5-1j, 7+1j, -1+7j, -5-3j, 3-5j, 3-7j, 7+3j,
    1+5j, 5-1j, 5-3j, -3-5j, -7+1j, 1+7j, -3-7j, -7+3j,
    -5+1j, -1-5j, 3+5j, -5+3j, -1-7j, 7-1j, 7-3j, 3+7j,
    5+5j, 5-5j, 5-7j, -7-5j, -7+5j, 5+7j, -7-7j, -7+7j,
    -5+5j, -5-5j, 7+5j, -5+7j, -5-7j, 7-5j, 7-7j, 7+7j,
], dtype=np.complex64)

# pair-form LUT (float32 [64, 2]; host-side and rx use)
CONSTELLATION_64_PAIRS = np.stack(
    [CONSTELLATION_64.real, CONSTELLATION_64.imag], axis=-1
).astype(np.float32)
# rail-major LUT for the device path (float32 [2, 64]): indexing with a
# symbol array gives the rail-major cells [2, n] (core/cplx.rails_to_np)
CONSTELLATION_64_RAILS = np.ascontiguousarray(CONSTELLATION_64_PAIRS.T)


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

@functools.cache
def _rs() -> RsBitEncoder:
    """(127,122) RS over GF(128), g(x) = Π_{i=1..5}(x + α^i); the code is
    singly extended to (128,122) with an overall GF-sum parity symbol
    (PARITY-RISK: root span and extension rule from recall of SCTE 07 §5.3).
    """
    return RsBitEncoder(GF128, k_sym=RS_K, nroots=5, first_root=1)


@functools.cache
def _ext_sum_matrix() -> np.ndarray:
    """GF(2) matrix [127*7, 7]: extension symbol = GF-sum (XOR) of all 127
    symbols — per-bitplane XOR, i.e. a parity matrix with identity blocks."""
    m = np.zeros((127 * 7, 7), dtype=np.uint8)
    for s in range(127):
        m[s * 7:(s + 1) * 7] = np.eye(7, dtype=np.uint8)
    return m


@functools.cache
def _randomizer_frame() -> np.ndarray:
    """Per-frame randomizer sequence: 7680 GF(128) symbols from the degree-3
    LFSR over GF(128) x³ + x + α³, reseeded to all-ones each FSYNC
    (PARITY-RISK: polynomial/seed from recall of SCTE 07 §5.6).  The adder is
    GF addition = XOR.  Computed once (it is identical every frame)."""
    gf = GF128
    alpha3 = gf.pow_alpha(3)
    state = [1, 1, 1]
    out = np.empty(FRAME_SYMBOLS, dtype=np.int64)
    for i in range(FRAME_SYMBOLS):
        out[i] = state[2]
        fb = int(gf.mul(state[2], alpha3)) ^ state[1]
        state = [fb, state[0], state[1]]
    return out


@functools.cache
def _framing_crc_matrix() -> np.ndarray:
    """GF(2) matrix [187*8, 8] for the transport-framing parity checksum
    that replaces the MPEG sync byte (PARITY-RISK: polynomial
    x⁸+x⁷+x⁶+x⁴+x²+1 borrowed from the DVB mode-adaptation CRC as a stand-in
    for the SCTE 07 §5.2 checksum; structure — sync byte replaced by a
    checksum over the packet's 187 payload bytes — is per spec)."""
    from dtv_utils_tpu.core.galois import gf2_poly_mod_matrix
    g = np.zeros(9, dtype=np.uint8)
    for p in (0, 2, 4, 6, 7, 8):
        g[p] = 1
    return gf2_poly_mod_matrix(g, 187 * 8)


def _fsync_bits() -> np.ndarray:
    w = np.zeros(FSYNC_BITS, dtype=np.uint8)
    for i in range(FSYNC_BITS):
        w[i] = (FSYNC_WORD >> (FSYNC_BITS - 1 - i)) & 1
    return w


# ---------------------------------------------------------------------------
# Stream state
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass
class J83bState:
    ilv_carry: jax.Array    # int32 [(I-1)*I*J] interleaver tail symbols
    conv_a: jax.Array       # uint8 [4] encoder A memory (most recent first)
    conv_b: jax.Array       # uint8 [4] encoder B memory
    diff_state: jax.Array   # uint8 [2] differential precoder (W, Z)
    rrc_tail: jax.Array     # float32 [2, 49] filter history (rail-major)


def init_state(cfg: J83bConfig | None = None) -> J83bState:
    return J83bState(
        ilv_carry=jnp.zeros((ILV_I - 1) * ILV_I * ILV_J, jnp.int32),
        conv_a=jnp.zeros(4, jnp.uint8),
        conv_b=jnp.zeros(4, jnp.uint8),
        diff_state=jnp.zeros(2, jnp.uint8),
        rrc_tail=jnp.zeros((2, 49), jnp.float32),
    )


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def transport_framing(ts: jax.Array) -> jax.Array:
    """[n_pkt, 188] uint8 → same, sync byte replaced by parity checksum."""
    payload_bits = bitops.bytes_to_bits(ts[:, 1:])
    from dtv_utils_tpu.core.galois import gf2_matmul
    crc_bits = gf2_matmul(payload_bits, jnp.asarray(
        _framing_crc_matrix().astype(np.int8)))
    crc = bitops.bits_to_bytes(crc_bits)             # [n_pkt, 1]
    return jnp.concatenate([crc, ts[:, 1:]], axis=1)


def rs_encode(symbols7: jax.Array) -> jax.Array:
    """[n_blocks, 122] int32 7-bit symbols → [n_blocks, 128] codewords."""
    enc = _rs()
    msg_bits = bitops.words_to_bits(symbols7, 7)
    par_bits = enc.parity_bits(msg_bits)             # [n, 5*7]
    cw126_bits = jnp.concatenate([msg_bits, par_bits], axis=-1)
    from dtv_utils_tpu.core.galois import gf2_matmul
    ext_bits = gf2_matmul(cw126_bits, jnp.asarray(
        _ext_sum_matrix()[: 127 * 7].astype(np.int8)))
    cw_bits = jnp.concatenate([cw126_bits, ext_bits], axis=-1)
    return bitops.bits_to_words(cw_bits, 7)


def interleave(symbols: jax.Array, carry: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Forney (I=128, J=4) over 7-bit symbols: out[k]=in[k - (k%I)*I*J].

    Formulation: with ext = carry ++ symbols viewed [*, I], the output is
    the column shear out2d[r, b] = ext2d[r + C/I - J*b, b] (C = carry
    length; non-negative slice starts for all branches need
    C/I >= J*(I-1), i.e. C >= I*J*(I-1) — asserted below, because
    jax.lax.dynamic_slice silently CLAMPS a negative start and would
    corrupt the interleave instead of failing).  The
    shear runs on the TRANSPOSED [I, *] layout where each branch is a
    contiguous row: one relayout transpose, a vmapped dynamic_slice
    (contiguous lane reads), and a transpose back — replacing 128
    lane-strided gathers that dominated the encode profile."""
    n = symbols.shape[0]
    C = carry.shape[0]
    assert n % ILV_I == 0 and C % (ILV_I * ILV_J) == 0
    # dynamic_slice clamps negative starts silently; require every branch
    # start C/I - J*b >= 0 (ADVICE r4: C % (I*J) == 0 alone does NOT imply
    # this — init_state's (I-1)*I*J happens to satisfy it exactly).
    assert C // ILV_I >= ILV_J * (ILV_I - 1)
    rows = n // ILV_I
    ext = jnp.concatenate([carry, symbols])
    extT = ext.reshape(-1, ILV_I).T                  # [I, C/I + rows]
    # branch starts C/I - J*b are Python ints — STATIC slices, which fuse
    # into one copy (no dynamic-slice lowering)
    branches = jnp.stack(
        [jax.lax.slice(extT, (b, C // ILV_I - ILV_J * b),
                       (b + 1, C // ILV_I - ILV_J * b + rows))[0]
         for b in range(ILV_I)])                     # [I, rows]
    out = branches.T.reshape(n)
    return out, ext[-C:]


def conv_encode_45(bits: jax.Array, state: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Rate-4/5 punctured binary conv code over one substream.

    bits: uint8 [n] (n % 4 == 0) → kept output bits [n//4*5], new state.
    """
    n = bits.shape[0]
    ext = jnp.concatenate([state[::-1].astype(jnp.uint8), bits])
    x = jnp.zeros(n, jnp.uint8)
    y = jnp.zeros(n, jnp.uint8)
    for j in G1_TAPS:
        x = x ^ ext[4 - j: 4 - j + n]
    for j in G2_TAPS:
        y = y ^ ext[4 - j: 4 - j + n]
    xy = jnp.stack([x, y], axis=-1).reshape(-1, 8)   # per 4-step period
    keep = []
    for i in range(4):
        if PUNCT_X[i]:
            keep.append(2 * i)
        if PUNCT_Y[i]:
            keep.append(2 * i + 1)
    out = xy[:, np.asarray(keep, dtype=np.int32)].reshape(-1)
    return out, bits[-4:][::-1]


def trellis_encode(bits: jax.Array, conv_a, conv_b, diff_state):
    """TCM: serial bits [n] (n % 28 == 0) → 6-bit symbol words [n//28*5].

    Group layout (PARITY-RISK, §5.5 recall): 28 bits split alternately into
    A (even positions) and B (odd); within each 14-bit substream the first
    10 bits are uncoded (2 per symbol), the last 4 feed the rate-4/5 coder
    (1 coded bit per symbol).

    Word layout is pinned by the EXACT reference constellation literal
    (qam-blade.py:57): multiplying any point by j maps its index to the
    index with Gray-advanced bits (b3, b0) and bits b5 b4 b2 b1 unchanged
    (verified exhaustively in tests/test_j83b_invariants.py).  90°
    rotational invariance therefore requires the differentially-precoded
    quadrant pair to occupy (b3, b0) as its Gray code, with the uncoded
    payload bits on (b5, b4) and the coded bits on (b2, b1):
    word = [uA, uB, qGrayHi, cA, cB, qGrayLo] (MSB..LSB).
    """
    g = bits.reshape(-1, TRELLIS_GROUP_IN)
    n_grp = g.shape[0]
    a = g[:, 0::2]                                   # [n_grp, 14]
    b = g[:, 1::2]
    ua, ca_in = a[:, :10], a[:, 10:]
    ub, cb_in = b[:, :10], b[:, 10:]
    ca, conv_a = conv_encode_45(ca_in.reshape(-1), conv_a)
    cb, conv_b = conv_encode_45(cb_in.reshape(-1), conv_b)
    ca = ca.reshape(n_grp, 5)
    cb = cb.reshape(n_grp, 5)
    # uncoded bits per symbol: A gives (w, u) and B gives (z, v)
    w = ua.reshape(n_grp, 5, 2)[..., 0].reshape(-1)  # per-symbol streams
    u = ua.reshape(n_grp, 5, 2)[..., 1].reshape(-1)
    z = ub.reshape(n_grp, 5, 2)[..., 0].reshape(-1)
    v = ub.reshape(n_grp, 5, 2)[..., 1].reshape(-1)
    # 90°-invariance differential precoder on (w, z): the top bit pair is a
    # quadrant number in Gray code; differential encoding is a running sum
    # of quadrant increments mod 4 — a plain cumsum, fully vectorized.
    #   gray (w,z): 00→0, 01→1, 11→2, 10→3
    q_in = (w.astype(jnp.int32) << 1) | (w ^ z).astype(jnp.int32)
    q0 = ((diff_state[0].astype(jnp.int32) << 1)
          | (diff_state[0] ^ diff_state[1]).astype(jnp.int32))
    q_out = (jnp.cumsum(q_in) + q0) & 3
    W = (q_out >> 1).astype(jnp.uint8)                # Gray hi → b3
    Z = (W ^ (q_out & 1).astype(jnp.uint8))           # Gray lo → b0
    new_diff = jnp.stack([W[-1], Z[-1]])
    words = ((u.astype(jnp.int32) << 5) | (v.astype(jnp.int32) << 4)
             | (W.astype(jnp.int32) << 3)
             | (ca.reshape(-1).astype(jnp.int32) << 2)
             | (cb.reshape(-1).astype(jnp.int32) << 1)
             | Z.astype(jnp.int32))
    return words, conv_a, conv_b, new_diff


def rrc_taps(cfg: J83bConfig) -> np.ndarray:
    """GNU Radio firdes.root_raised_cosine(0.14, fs, fs/2, 0.18, 100)
    (qam-blade.py:59): standard RRC impulse response, taps scaled so their
    sum equals the gain argument."""
    gain, ntaps, alpha = 0.14, cfg.rrc_ntaps, cfg.rrc_rolloff
    fs = float(cfg.sample_rate)
    sym = fs / 2.0
    spb = fs / sym                                   # samples per symbol = 2
    taps = np.zeros(ntaps)
    for i in range(ntaps):
        t = (i - ntaps / 2.0) / spb
        den = 1.0 - (4.0 * alpha * t) ** 2
        if abs(t) < 1e-12:
            taps[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(den) < 1e-9:
            taps[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha)))
        else:
            taps[i] = (np.sin(np.pi * t * (1.0 - alpha))
                       + 4.0 * alpha * t * np.cos(np.pi * t * (1.0 + alpha))
                       ) / (np.pi * t * den)
    return (gain * taps / np.sum(taps)).astype(np.float32)


def rrc_interpolate(cells: jax.Array, tail: jax.Array,
                    taps: np.ndarray) -> tuple[jax.Array, jax.Array]:
    """Interpolate-by-2 polyphase RRC: rail-major IQ [2, n] → [2, 2n] +
    history [2, 49].

    output[:, 2m + p] = Σ_k h[2k + p] · x[:, m + 49 − k]: per phase, a
    weighted sum of 50 shifted slices of the (re, im) rails, which XLA
    fuses into one elementwise loop (one read of the input, one write of
    the output).  Plain float32 multiplies and adds: no dot or conv, so no
    reduced-precision (TF32) path exists.
    """
    n = cells.shape[1]
    x = jnp.concatenate([tail, cells], axis=1)       # [2, 49 + n]
    outs = []
    for p in range(2):
        hp = taps[p::2][::-1]                        # [50], flipped
        y = None
        for j, h in enumerate(hp.tolist()):
            term = jax.lax.slice(x, (0, j), (2, j + n)) * jnp.float32(h)
            y = term if y is None else y + term
        outs.append(y)                               # [2, n]
    out = jnp.stack(outs, axis=-1).reshape(2, -1)    # [2, 2n] interleaved
    return out, x[:, -49:]


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------

def encode_to_cells(cfg: J83bConfig, ts: jax.Array,
                    state: J83bState) -> tuple[jax.Array, J83bState]:
    """Stages framing … 64-QAM map: ts uint8 [6405*188] → rail-major IQ
    cells [2, 1,806,210] + next state (rrc_tail unchanged here)."""
    del cfg
    n_pkt = PACKETS_PER_SUPERBLOCK
    framed = transport_framing(ts.reshape(n_pkt, 188)).reshape(-1)

    # 7-bit symbolization (MSB-first across byte boundaries)
    bits = bitops.bytes_to_bits(framed)
    info_syms = bitops.bits_to_words(bits.reshape(-1, 7), 7).reshape(-1)

    # RS(128,122) extended
    cw = rs_encode(info_syms.reshape(-1, RS_K)).reshape(-1)

    # convolutional interleaver over symbols
    inter, ilv_carry = interleave(cw.astype(jnp.int32), state.ilv_carry)

    # randomizer (GF add = XOR), identical sequence every frame
    rnd = jnp.asarray(np.tile(_randomizer_frame(),
                              FRAMES_PER_SUPERBLOCK).astype(np.int32))
    randomized = inter ^ rnd

    # frame sync insertion: per frame, 53760 payload bits + 42 sync bits
    pay_bits = bitops.words_to_bits(
        randomized.reshape(FRAMES_PER_SUPERBLOCK, FRAME_SYMBOLS), 7)
    sync = jnp.asarray(np.tile(_fsync_bits(), (FRAMES_PER_SUPERBLOCK, 1)))
    frame_bits = jnp.concatenate([pay_bits, sync], axis=1).reshape(-1)

    # trellis-coded modulation → 6-bit words → constellation
    words, conv_a, conv_b, diff = trellis_encode(
        frame_bits, state.conv_a, state.conv_b, state.diff_state)
    cells = jnp.asarray(CONSTELLATION_64_RAILS)[:, words]
    return cells, J83bState(ilv_carry=ilv_carry, conv_a=conv_a,
                            conv_b=conv_b, diff_state=diff,
                            rrc_tail=state.rrc_tail)


def modulate_superblock(cfg: J83bConfig, ts: jax.Array,
                        state: J83bState) -> tuple[jax.Array, J83bState]:
    """188 FEC frames: ts uint8 [6405*188] → rail-major IQ
    [2, 3,612,420] (cplx.rails_to_np converts to host complex/pairs)."""
    cells, state = encode_to_cells(cfg, ts, state)
    iq, rrc_tail = rrc_interpolate(cells, state.rrc_tail, rrc_taps(cfg))
    return iq, J83bState(ilv_carry=state.ilv_carry, conv_a=state.conv_a,
                         conv_b=state.conv_b, diff_state=state.diff_state,
                         rrc_tail=rrc_tail)


@functools.cache
def jit_modulator(cfg: J83bConfig):
    return jax.jit(functools.partial(modulate_superblock, cfg))


def modulate_stream(cfg: J83bConfig, ts: np.ndarray,
                    state: J83bState | None = None):
    blk = PACKETS_PER_SUPERBLOCK * 188
    assert len(ts) % blk == 0, f"need multiple of {blk} TS bytes"
    if state is None:
        state = init_state(cfg)
    fn = jit_modulator(cfg)
    out = []
    for i in range(len(ts) // blk):
        iq, state = fn(jnp.asarray(ts[i * blk:(i + 1) * blk]), state)
        out.append(cplx.rails_to_np(iq))
    return (np.concatenate(out) if out else np.empty(0, np.complex64)), state
