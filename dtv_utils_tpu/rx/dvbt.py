"""DVB-T receiver (EN 300 744).

Software counterpart of the consumer receivers the reference validates
against over the air (README:26-28; TX chain /root/reference/
dvbt-blade.py:179-210).  Inverts the full tx/dvbt.py chain:

  IQ → CP strip → forward FFT → carrier extraction →
  pilot-phase detection → TPS decode (differential + BCH syndrome check) →
  composed de-interleave gather → max-log SOFT demap (per-bit LLRs) →
  depuncture → block-parallel soft Viterbi (ops/viterbi.py) → Forney
  deinterleave → Berlekamp-Massey RS(204,188) correction
  (ops/rs_decode.py) → energy de-dispersal → TS.

Alignment contract: the IQ stream starts at a superframe boundary (the
modulator's output contract).  Pilot-phase and TPS decoding are performed
from the signal and surfaced in the result for receiver-style validation —
the demodulator does not assume the transmit configuration is honest, it
checks it.

Everything heavy is jit-compiled with static shapes; the demap and all
de-interleavers are single precomputed gathers mirroring the modulator's
composed-gather design.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core import cplx
from dtv_utils_tpu.core.config import DvbtConfig
from dtv_utils_tpu.core.prbs import dvbt_dispersal_mask, dvbt_pilot_signs
from dtv_utils_tpu.ops.cfft import fft_pairs, ifftshift_pairs
from dtv_utils_tpu.ops.rs_decode import DVBT_RS_DEC
from dtv_utils_tpu.ops.viterbi import viterbi_decode_punctured
from dtv_utils_tpu.tx import dvbt_tables as T
from dtv_utils_tpu.tx.dvbt import OUTPUT_SCALE, OUTER_I, OUTER_M, _plan


@dataclass
class DvbtRxResult:
    ts: np.ndarray            # uint8 recovered transport stream
    rs_errors: np.ndarray     # int32 [n_pkts] corrected byte errors
    rs_ok: np.ndarray         # bool [n_pkts] packet decodable
    phase_ok: bool            # scattered-pilot phase sequence as expected
    tps: dict                 # decoded TPS fields + BCH syndrome status


@functools.cache
def _rx_plan(cfg: DvbtConfig):
    """Host-side inverse tables derived from the TX plan (single source of
    truth: inverting the actual transmit tables, not re-deriving them)."""
    p = _plan(cfg)
    v = cfg.constellation.bits_per_symbol
    K = cfg.mode.carriers
    n_data = cfg.mode.data_carriers

    # inverse of the composed symbol-interleave gather:
    # TX: carriers[l, k] = lut[words[l, comp_idx[ph, k]]] on data positions.
    inv_idx = np.zeros((4, n_data), dtype=np.int32)
    for ph in range(4):
        k_pos = np.where(p["data_mask"][ph])[0]
        inv_idx[ph, p["comp_idx"][ph][k_pos]] = k_pos

    # axis demapper: value -> axis bits (sign + Gray magnitude)
    half = v // 2
    L = 1 << half
    lut_c = T.constellation_lut(cfg.constellation)
    norm = {1: np.sqrt(2.0), 2: np.sqrt(10.0), 3: np.sqrt(42.0)}[half]
    # axis word w (bit half-1 = sign ... ) -> level; build inverse
    axis_bits_of_q = np.zeros(L, dtype=np.int32)
    # enumerate axis words via the constellation LUT's own I axis
    for w in range(L):
        # word with re-axis bits = w, im-axis bits = 0
        bits = np.zeros(v, dtype=np.int64)
        for i in range(half):
            bits[2 * i] = (w >> (half - 1 - i)) & 1
        word = 0
        for b in bits:
            word = (word << 1) | int(b)
        val = lut_c[word].real * norm
        q = int(round((val + (2 * L - 1) - L) / 2))  # levels ±1..±(2L-1)
        axis_bits_of_q[q] = w
    # max-log soft demap tables: per axis, the L level values and each
    # level's axis-bit pattern (sign + Gray), for per-bit LLRs
    axis_levels = np.empty(L, dtype=np.float32)
    axis_bits = np.empty((L, half), dtype=np.uint8)
    for q in range(L):
        w = axis_bits_of_q[q]
        axis_levels[q] = (2 * q - (L - 1)) / norm
        axis_bits[q] = [(w >> (half - 1 - i)) & 1 for i in range(half)]

    # inverse of the bit-plane packing: kept-stream position of (u % P, e)
    from dtv_utils_tpu.ops.convcode import PUNCTURE_PATTERNS
    xp, yp = PUNCTURE_PATTERNS[cfg.code_rate.value]
    keep_cols = []
    for i in range(len(xp)):
        if xp[i]:
            keep_cols.append(2 * i)
        if yp[i]:
            keep_cols.append(2 * i + 1)
    demux_pos = np.argsort(np.asarray(T.DEMUX[v]))
    P = p["gen_P"]
    s0_of = np.zeros(P * v, dtype=np.int64)     # (u*v + e) -> kept index
    for u in range(P):
        blk_base = (u // T.BIT_ILV_BLOCK) * T.BIT_ILV_BLOCK
        for e in range(v):
            u2 = blk_base + ((u % T.BIT_ILV_BLOCK) + T.BIT_ILV_OFFSETS[e]) \
                % T.BIT_ILV_BLOCK
            s0_of[u * v + e] = v * u2 + int(demux_pos[e])
    inv_s0 = np.argsort(s0_of).astype(np.int32)  # kept index -> (u*v+e)

    # pilot references for phase detection
    w_sign = dvbt_pilot_signs(K)
    scat_ref = []
    for ph in range(4):
        s = T.scattered_pilots(cfg.mode, ph)
        ref = np.zeros(K, dtype=np.float32)
        ref[s] = w_sign[s]
        scat_ref.append(ref)

    # Forney deinterleave gather over the whole coded stream is built at
    # run time (depends on stream length); the per-packet dispersal masks:
    mask, _ = dvbt_dispersal_mask()

    return dict(inv_idx=inv_idx, inv_s0=inv_s0,
                axis_levels=axis_levels, axis_bits=axis_bits,
                scat_ref=np.stack(scat_ref), dispersal=mask,
                tps_carriers=T.tps_carriers(cfg.mode).astype(np.int32),
                tps_base=w_sign[T.tps_carriers(cfg.mode)].astype(np.float32))


def iq_to_carriers(cfg: DvbtConfig, iq: jnp.ndarray) -> jnp.ndarray:
    """IQ pairs [n, 2] -> carrier grid [n_sym, K, 2] (inverse of
    tx.dvbt.carriers_to_iq)."""
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.mode.carriers
    sym = iq.reshape(-1, fft + gi, 2)[:, gi:, :]
    spec = ifftshift_pairs(fft_pairs(sym, sign=-1)) / (fft * OUTPUT_SCALE)
    left = (fft - K + 1) // 2
    return spec[:, left:left + K, :]


def _extract_cells(cfg: DvbtConfig, carriers: jnp.ndarray) -> jnp.ndarray:
    """Carrier grid -> de-interleaved data-cell values [n_cells, 2]."""
    p = _rx_plan(cfg)
    n_sym = carriers.shape[0]
    inv = jnp.asarray(p["inv_idx"])            # [4, n_data]
    idx = inv[jnp.arange(n_sym) % 4]           # [n_sym, n_data]
    cells = jnp.take_along_axis(carriers, idx[:, :, None], axis=1)
    return cells.reshape(-1, 2)


def _cell_bit_llrs(cfg: DvbtConfig, cells: jnp.ndarray) -> jnp.ndarray:
    """Max-log per-bit LLRs [n_cells, v] (positive = bit 0): per axis,
    LLR_b = min_{levels with bit 1} d² − min_{levels with bit 0} d².
    Even cell-word bits come from I, odd from Q (EN 300 744 §4.3.5)."""
    p = _rx_plan(cfg)
    v = cfg.constellation.bits_per_symbol
    half = v // 2
    lv = jnp.asarray(p["axis_levels"])         # [L]
    ab = jnp.asarray(p["axis_bits"])           # [L, half]
    big = jnp.float32(1e30)

    def axis_llrs(x):                          # x [n] -> [n, half]
        d2 = (x[:, None] - lv[None, :]) ** 2   # [n, L]
        outs = []
        for b in range(half):
            m1 = ab[:, b] == 1
            d1 = jnp.min(jnp.where(m1[None, :], d2, big), axis=1)
            d0 = jnp.min(jnp.where(m1[None, :], big, d2), axis=1)
            outs.append(d1 - d0)
        return jnp.stack(outs, axis=1)

    li = axis_llrs(cells[:, 0])                # [n, half]
    lq = axis_llrs(cells[:, 1])
    return jnp.stack([li, lq], axis=2).reshape(-1, v)  # even=I, odd=Q


def detect_symbol_phase(cfg: DvbtConfig, carriers: jnp.ndarray) -> jnp.ndarray:
    """Per-symbol scattered-pilot phase estimate [n_sym] in 0..3 — receiver-
    style validation that the frame structure is where the config says."""
    p = _rx_plan(cfg)
    ref = jnp.asarray(p["scat_ref"])           # [4, K]
    score = jnp.einsum("lk,pk->lp", carriers[..., 0], ref,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.argmax(score, axis=1)


def decode_tps(cfg: DvbtConfig, carriers: jnp.ndarray) -> dict:
    """Differential TPS decode + BCH(67,53) syndrome check per frame."""
    p = _rx_plan(cfg)
    tpsc = jnp.asarray(p["tps_carriers"])
    base = jnp.asarray(p["tps_base"])
    r = carriers[:, tpsc, 0] * base[None, :]   # [n_sym, n_tps]
    d = jnp.sign(jnp.sum(jnp.sign(r), axis=1))  # majority vote per symbol
    d = np.asarray(d).reshape(-1, 68)          # [n_frames, 68]
    s = (d[:, 1:] != d[:, :-1]).astype(np.uint8)
    s = np.concatenate([np.zeros((len(d), 1), np.uint8), s], axis=1)
    out = {"frames": []}
    g = T._TPS_BCH_M.astype(np.int64)
    for f, sf in enumerate(s):
        parity = (sf[1:54].astype(np.int64) @ g) & 1
        bch_ok = bool(np.array_equal(parity, sf[54:68]))
        sync_odd = bool(np.array_equal(sf[1:17], T.TPS_SYNC_ODD))
        sync_even = bool(np.array_equal(sf[1:17], T.TPS_SYNC_EVEN))
        out["frames"].append(dict(
            bch_ok=bch_ok,
            sync=("odd" if sync_odd else "even" if sync_even else "BAD"),
            frame_number=int((sf[23] << 1) | sf[24]),
            constellation=int((sf[25] << 1) | sf[26]),
            code_rate_hp=int((sf[30] << 2) | (sf[31] << 1) | sf[32]),
            guard=int((sf[36] << 1) | sf[37]),
            mode=int((sf[38] << 1) | sf[39]),
        ))
    out["all_bch_ok"] = all(fr["bch_ok"] for fr in out["frames"])
    return out


@functools.cache
def _jit_front(cfg: DvbtConfig):
    def front(iq):
        carriers = iq_to_carriers(cfg, iq)
        cells = _extract_cells(cfg, carriers)
        phases = detect_symbol_phase(cfg, carriers)
        return carriers, cells, phases
    return jax.jit(front)


@functools.cache
def _jit_llrs_to_coded(cfg: DvbtConfig):
    """cells [n_cells, 2] -> decoded coded-stream bytes (soft demap +
    Viterbi): the bit-plane inverse permutation applies to the LLR stream
    exactly as it applied to hard bit-planes."""
    p = _rx_plan(cfg)

    def fn(cells):
        llrs = _cell_bit_llrs(cfg, cells)      # [n_cells, v], + = bit 0
        z = llrs.reshape(-1, len(p["inv_s0"]))[:, jnp.asarray(p["inv_s0"])]
        bits = viterbi_decode_punctured(z.reshape(-1), cfg.code_rate.value)
        return bitops.bits_to_bytes(bits)
    return jax.jit(fn)


@functools.cache
def _jit_tail(n_pkts: int):
    """outer-interleaved bytes -> (corrected packets, n_err, ok), jitted so
    the Berlekamp-Massey iteration compiles to one dispatch."""
    j = np.arange(n_pkts * 204, dtype=np.int64)
    gather = jnp.asarray(j + 204 * (j % OUTER_I))

    def fn(outer_bytes):
        coded = outer_bytes[gather].reshape(n_pkts, 204)
        corrected, n_err, ok = DVBT_RS_DEC().decode_bytes(coded)
        return corrected[:, :188], n_err, ok
    return jax.jit(fn)


def demodulate_stream(cfg: DvbtConfig, iq: np.ndarray) -> DvbtRxResult:
    """IQ (complex64 [n] or float32 pairs [n, 2]) -> recovered TS.

    Decodes every complete TS packet recoverable from the stream (the
    Forney deinterleaver's 2244-byte tail stays in flight, exactly like a
    hardware receiver's deinterleaver latency).
    """
    if iq.dtype == np.complex64:
        iq = np.stack([iq.real, iq.imag], axis=-1)
    n_spf = cfg.symbols_per_superframe * (cfg.fft_size + cfg.guard_samples)
    assert len(iq) % n_spf == 0, f"need whole superframes of {n_spf} samples"

    carriers, cells, phases = _jit_front(cfg)(jnp.asarray(iq))
    outer_bytes = _jit_llrs_to_coded(cfg)(cells)

    # Forney deinterleave (inverse of tx/dvbt.py stage 3, zero initial carry):
    # coded[j] = outer[j + 204*(j % 12)]
    total = int(outer_bytes.shape[0])
    carry = OUTER_I * OUTER_M * (OUTER_I - 1)
    n_pkts = max((total - carry) // 204, 0)
    corrected, n_err, ok = _jit_tail(n_pkts)(outer_bytes)
    pkts = np.asarray(corrected)

    # energy de-dispersal (XOR is involutive; phase = packet index mod 8)
    mask, _ = dvbt_dispersal_mask()
    mrows = mask.reshape(8, 188)
    ts = (pkts ^ mrows[np.arange(n_pkts) % 8]).reshape(-1)

    phase_np = np.asarray(phases)
    tps = decode_tps(cfg, carriers)
    return DvbtRxResult(
        ts=ts,
        rs_errors=np.asarray(n_err),
        rs_ok=np.asarray(ok),
        phase_ok=bool(np.array_equal(phase_np,
                                     np.arange(len(phase_np)) % 4)),
        tps=tps,
    )


def demodulate_iq_pairs(cfg: DvbtConfig, iq_pairs) -> DvbtRxResult:
    return demodulate_stream(cfg, cplx.to_np(iq_pairs))
