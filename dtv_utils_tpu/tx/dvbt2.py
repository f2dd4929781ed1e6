"""DVB-T2 modulator (EN 302 755).

Re-expresses the reference chain — the 14-block GNU Radio flowgraph at
/root/reference/dvbt2-blade.py:119-156 (BB header → BB scrambler → BCH →
LDPC → bit interleaver → constellation/rotation → cell interleaver → frame
mapper → freq interleaver → pilots → PAPR TR → cyclic prefix → P1) — as one
jit array program over an *interleaving frame* (= one T2 frame here):

  * mode adaptation (sync-byte CRC-8 replacement, BB headers with running
    SYNCD) is a phase-parameterized gather + two GF(2) bit-matmuls — no
    per-packet loop, the packet phase lives in a tiny stream-state pytree;
  * BB scrambling is one XOR with a precomputed PRBS;
  * BCH parity is a bit-matmul [blocks, kbch] x [kbch, 160|192];
  * LDPC (IRA) encoding is a gather + scatter-XOR over the accumulator
    edges followed by a prefix-XOR (cumsum mod 2) — the two sequential
    structures of the standard become two parallel primitives;
  * every interleaver (parity/column-twist/demux/cell/time) is a static
    gather precomputed in dvbt2_tables.py.

IQ is float32 (re, im) pairs [..., 2] (core/cplx.py).  Table exactness
status is tracked in PARITY.md (LDPC annex tables are stand-ins).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core.config import Dvbt2Config, T2Constellation
from dtv_utils_tpu.core.galois import gf2_matmul, gf2_poly_mod_matrix
from dtv_utils_tpu.core.prbs import bb_scrambler_bits
from dtv_utils_tpu.tx import dvbt2_tables as T

# DVB CRC-8 (EN 302 755 §5.1.4): x^8+x^7+x^6+x^4+x^2+1
_CRC8_POLY = np.array([1, 0, 1, 0, 1, 0, 1, 1, 1], dtype=np.uint8)


@jax.tree_util.register_dataclass
@dataclass
class Dvbt2State:
    """Stream state between consecutive interleaving frames."""
    packet_phase: jax.Array   # int32: bytes into the current 188-byte packet
    prev_tail: jax.Array      # uint8 [187]: previous raw bytes (CRC window)


def init_state(cfg: Dvbt2Config) -> Dvbt2State:
    del cfg
    return Dvbt2State(packet_phase=jnp.zeros((), jnp.int32),
                      prev_tail=jnp.zeros(187, jnp.uint8))


@functools.cache
def _plan(cfg: Dvbt2Config):
    kbch = cfg.kbch
    dfl_bytes = (kbch - 80) // 8
    n_bytes = dfl_bytes * cfg.fec_blocks
    bch_m = T.bch_parity_matrix(cfg.frame_size, cfg.bch_t, kbch
                                ).astype(np.int8)
    crc8_m = gf2_poly_mod_matrix(_CRC8_POLY, 187 * 8).astype(np.int8)
    hdr_crc_m = gf2_poly_mod_matrix(_CRC8_POLY, 72).astype(np.int8)
    scramble = bb_scrambler_bits(kbch)
    # LDPC accumulator edges in the rotated quasi-cyclic basis: address
    # a = c + q*s of group g means parity[(s+m)%360, c] ^= info[g, m] — so
    # the whole pre-accumulator is a [360, E] gather plus one tiny int8
    # matmul against an [E, q] column-selector (parity via integer sum).
    rows_ldpc = T.ldpc_accumulator_rows(cfg.code_rate.value, cfg.nldpc,
                                        cfg.nbch)
    q = cfg.ldpc_q
    ldpc_g, ldpc_s, ldpc_c = [], [], []
    for g, addrs in enumerate(rows_ldpc):
        for a in addrs:
            ldpc_g.append(g)
            ldpc_s.append(a // q)
            ldpc_c.append(a % q)
    E = len(ldpc_g)
    # contrib[b,e,r] = info3[b, g_e, (r - s_e) % 360] = EXT[b, base_e + r]
    # with EXT the per-group doubled info laid flat — base_e is STATIC, so
    # every edge is one contiguous static slice (no gathers at all).
    ldpc_base = [g * 720 + (360 - s) % 360
                 for g, s in zip(ldpc_g, ldpc_s)]
    ldpc_sel = np.zeros((E, q), dtype=np.int8)
    ldpc_sel[np.arange(E), ldpc_c] = 1
    bit_perm = T.bit_interleaver_perm(cfg)
    dperm = T.demux_perm(cfg)
    v = cfg.constellation.bits_per_symbol
    lut = T.constellation_pairs(cfg.constellation, cfg.rotation)
    ncells = cfg.cells_per_fec_block
    ci_base = T.cell_interleaver_perm(ncells)
    ci_shift = T.cell_interleaver_shifts(cfg.fec_blocks, ncells)
    # scatter semantics out[L_r(q)] = in[q]  ->  gather index inverse
    ci_gather = np.empty((cfg.fec_blocks, ncells), dtype=np.int32)
    qidx = np.arange(ncells)
    for r in range(cfg.fec_blocks):
        lr = (ci_base + ci_shift[r]) % ncells
        ci_gather[r, lr] = qidx
    # time interleaver: TI block sizes (§6.5; uneven split like gr-dtv)
    nti = max(cfg.ti_blocks, 1)
    base, extra = divmod(cfg.fec_blocks, nti)
    ti_sizes = [base + (1 if i < extra else 0) for i in range(nti)]
    pow2 = (1 << np.arange(v - 1, -1, -1)).astype(np.int32)
    return dict(n_bytes=n_bytes, dfl_bytes=dfl_bytes, bch_m=bch_m,
                crc8_m=crc8_m, hdr_crc_m=hdr_crc_m,
                scramble=scramble, ldpc_base=tuple(ldpc_base),
                ldpc_sel=ldpc_sel,
                bit_perm=bit_perm, dperm=dperm, lut=lut,
                ci_gather=ci_gather, ti_sizes=tuple(ti_sizes), pow2=pow2)


def _crc8_rows(p, rows_bytes: jax.Array) -> jax.Array:
    """uint8 [..., 187] -> CRC-8 byte [...] via GF(2) matmul."""
    bits = bitops.bytes_to_bits(rows_bytes)
    crc_bits = gf2_matmul(bits, jnp.asarray(p["crc8_m"]))
    return bitops.bits_to_bytes(crc_bits)[..., 0]


def mode_adapt(cfg: Dvbt2Config, ts: jax.Array, state: Dvbt2State
               ) -> tuple[jax.Array, Dvbt2State]:
    """TS bytes [n_bytes] -> BBFRAMEs [fec_blocks, kbch] bits (unscrambled).

    Implements EN 302 755 §5.1 mode adaptation for TS, normal mode: the
    0x47 sync byte of each packet is replaced by the CRC-8 of the previous
    packet's 187 payload bytes; BB headers carry DFL/SYNCD bookkeeping.
    """
    p = _plan(cfg)
    n = p["n_bytes"]
    phase = state.packet_phase           # bytes into current packet
    ext = jnp.concatenate([state.prev_tail, ts])          # [187 + n]

    # sync positions: i_k = (188 - phase) % 188 + 188 k, masked to < n.
    # The windows/sync bytes form a CONTIGUOUS 188-stride lattice, so both
    # the CRC-window read and the sync-byte replacement are dynamic slices
    # + reshapes, never a general gather/scatter (which cost ~3x the whole
    # stage on 32K frames).
    first = (188 - phase) % 188
    n_sync = n // 188 + 1
    sync_pos = first + 188 * jnp.arange(n_sync, dtype=jnp.int32)
    valid = sync_pos < n
    # CRC over the 187 bytes before each sync position: in ext coords the
    # window is [pos, pos+187) since ext is shifted by 187.  One dynamic
    # slice of n_sync packets starting at `first`, then drop the sync col.
    ext_pad = jnp.concatenate(
        [ext, jnp.zeros(n_sync * 188 - n + 1, jnp.uint8)])
    win = jax.lax.dynamic_slice(ext_pad, (first,),
                                (n_sync * 188,)).reshape(n_sync, 188)[:, :187]
    crcs = _crc8_rows(p, win)
    # stream start: the very first packet of the whole stream has no
    # predecessor; its sync is replaced by CRC over zeros (prev_tail init).
    # Replacement: re-slice ts on the same lattice, swap column 0 for the
    # CRCs, write the block back at `first` and crop to n.
    ts_pad = jnp.concatenate([ts, jnp.zeros(n_sync * 188 + 188, jnp.uint8)])
    blk = jax.lax.dynamic_slice(ts_pad, (first,),
                                (n_sync * 188,)).reshape(n_sync, 188)
    sync_col = jnp.where(valid, crcs, blk[:, 0]).astype(jnp.uint8)
    blk = jnp.concatenate([sync_col[:, None], blk[:, 1:]], axis=1)
    adapted = jax.lax.dynamic_update_slice(
        ts_pad, blk.reshape(-1), (first,))[:n]

    data_bits = bitops.bytes_to_bits(adapted).reshape(cfg.fec_blocks, -1)

    # BB headers
    dfl = (cfg.kbch - 80)
    b = jnp.arange(cfg.fec_blocks, dtype=jnp.int32)
    phase_b = (phase + b * p["dfl_bytes"]) % 188
    syncd = ((188 - phase_b) % 188) * 8
    hdr_bytes = jnp.stack([
        jnp.full_like(b, 0xF0),               # MATYPE-1: TS, SIS, CCM
        jnp.zeros_like(b),                    # MATYPE-2
        jnp.full_like(b, 1504 >> 8), jnp.full_like(b, 1504 & 0xFF),  # UPL
        jnp.full_like(b, dfl >> 8), jnp.full_like(b, dfl & 0xFF),    # DFL
        jnp.full_like(b, 0x47),               # SYNC
        syncd >> 8, syncd & 0xFF,             # SYNCD
    ], axis=1).astype(jnp.uint8)
    hdr_bits = bitops.bytes_to_bits(hdr_bytes)            # [blocks, 72]
    crc_bits = gf2_matmul(hdr_bits, jnp.asarray(p["hdr_crc_m"]))
    header = jnp.concatenate([hdr_bits, crc_bits], axis=1)  # [blocks, 80]

    frames = jnp.concatenate([header, data_bits], axis=1)   # [blocks, kbch]
    new_state = Dvbt2State(packet_phase=(phase + n) % 188,
                           prev_tail=ts[-187:])
    return frames, new_state


def fec_encode(cfg: Dvbt2Config, bbframes: jax.Array) -> jax.Array:
    """BBFRAMEs [blocks, kbch] -> FECFRAMEs [blocks, nldpc] bits:
    scramble + BCH (matmul) + LDPC (scatter-XOR + prefix-XOR)."""
    p = _plan(cfg)
    scrambled = bbframes ^ jnp.asarray(p["scramble"])[None, :]
    bch_par = gf2_matmul(scrambled, jnp.asarray(p["bch_m"]))
    info = jnp.concatenate([scrambled, bch_par], axis=1)   # [blocks, nbch]

    # rotated-basis accumulator (see _plan): each edge contributes one
    # STATIC contiguous 360-slice of the doubled info; the column scatter is
    # one [b,360,E]x[E,q] int8 matmul (Σ mod 2 == XOR).
    q = cfg.ldpc_q
    b = info.shape[0]
    info3 = info.reshape(b, -1, 360).astype(jnp.int8)
    ext = jnp.concatenate([info3, info3], axis=2).reshape(b, -1)  # doubled
    # one row gather on the transposed layout: rows are [b] int8 vectors
    bases = np.asarray(p["ldpc_base"], dtype=np.int32)
    idx = (bases[:, None] + np.arange(360, dtype=np.int32)[None, :])
    rows = jnp.take(ext.T, jnp.asarray(idx.reshape(-1)), axis=0)
    contrib = jnp.transpose(
        rows.reshape(len(bases), 360, b), (2, 1, 0))       # [b, 360, E]
    pre_rot = jnp.matmul(contrib, jnp.asarray(p["ldpc_sel"]),
                         preferred_element_type=jnp.int32)  # [b, 360, q]
    pre = pre_rot.reshape(b, 360 * q)                      # p = q·r + c
    parity = (jnp.cumsum(pre, axis=1) & 1).astype(jnp.uint8)
    return jnp.concatenate([info, parity], axis=1)


def interleave_and_map(cfg: Dvbt2Config, fecframes: jax.Array) -> jax.Array:
    """FECFRAMEs [blocks, nldpc] -> rail-major cells [2, blocks, ncells]:
    bit interleaver + demux + map + rotation Q-delay.

    Rail-major from here to the OFDM back end: the payload-sized gathers
    downstream (cell/time interleave, frame assembly — ~2M cells for the
    32K BBC frame) keep the long axis minor."""
    p = _plan(cfg)
    v = cfg.constellation.bits_per_symbol
    x = fecframes
    # compose bit interleaver + demux into one permutation, applied as a ROW
    # gather on the transposed frame
    nsub = len(p["dperm"])
    nbits = x.shape[1]
    comp = np.arange(nbits, dtype=np.int32)
    if p["bit_perm"] is not None:
        comp = np.asarray(p["bit_perm"], dtype=np.int32)[comp]
    comp = comp.reshape(-1, nsub)[:, np.asarray(p["dperm"])].reshape(-1)
    yT = jnp.take(x.T, jnp.asarray(comp), axis=0).astype(jnp.int32)
    # bit-to-word sum as v strided row-slices of the TRANSPOSED stream
    # (minor dim stays `blocks`, no [blocks, nc, v] temp).  Integer
    # arithmetic, identical values.
    pow2 = [int(w) for w in np.asarray(p["pow2"]).reshape(-1)]
    words = sum(yT[e::v, :] * pow2[e] for e in range(v)).T
    lut_rails = np.ascontiguousarray(p["lut"].T)           # [2, m]
    cells = jnp.asarray(lut_rails)[:, words]               # [2, blocks, nc]
    if cfg.rotation:
        # cyclic Q delay of one cell within the FEC block (§6.3.3)
        q = jnp.roll(cells[1], 1, axis=1)
        cells = jnp.stack([cells[0], q], axis=0)
    return cells


def cell_time_interleave(cfg: Dvbt2Config, cells: jax.Array) -> jax.Array:
    """rail-major [2, blocks, ncells] -> interleaving-frame payload
    [2, blocks*ncells]: per-block cell interleaver, then row-column time
    interleaver per TI block (§6.4-6.5)."""
    p = _plan(cfg)
    nb, ncells0 = cells.shape[1], cells.shape[2]
    flat_idx = (np.arange(nb, dtype=np.int32)[:, None] * ncells0
                + p["ci_gather"]).reshape(-1)
    ci = jnp.take(cells.reshape(2, -1), jnp.asarray(flat_idx),
                  axis=1).reshape(2, nb, ncells0)
    out = []
    start = 0
    ncells = cfg.cells_per_fec_block
    assert ncells % 5 == 0
    nr = ncells // 5
    for size in p["ti_sizes"]:
        blk = ci[:, start:start + size]                # [2, size, ncells]
        nc = size * 5
        # write column-wise [nc, nr], read row-wise -> transpose
        mem = blk.reshape(2, nc, nr)
        out.append(jnp.swapaxes(mem, 1, 2).reshape(2, size * ncells))
        start += size
    return jnp.concatenate(out, axis=1)


def payload_cells(cfg: Dvbt2Config, ts: jax.Array, state: Dvbt2State
                  ) -> tuple[jax.Array, Dvbt2State]:
    """TS bytes -> time-interleaved PLP payload cells for one frame."""
    bb, state = mode_adapt(cfg, ts, state)
    fec = fec_encode(cfg, bb)
    cells = interleave_and_map(cfg, fec)
    return cell_time_interleave(cfg, cells), state


# ---------------------------------------------------------------------------
# L1 signalling encoding (§7.3): shortened BCH + punctured short LDPC
# ---------------------------------------------------------------------------

@functools.cache
def _l1_plan(cfg: Dvbt2Config):
    """Host-side: fully encoded L1-pre cells (static per config) and the
    L1-post encoder tables (dynamic fields re-encoded per frame)."""
    from dtv_utils_tpu.core.config import T2FrameSize
    from dtv_utils_tpu.core.galois import GF2_14_DVB, bch_generator_poly

    n_post, n_punc, eta = T.l1_sizes(cfg.l1_constellation, cfg.n_p2)

    def encode_short(info_bits: np.ndarray, kbch: int, nbch: int,
                     keep_parity: int) -> np.ndarray:
        """Shortened BCH(t=12, GF(2^14)) + stand-in LDPC + puncture."""
        ksig = len(info_bits)
        padded = np.concatenate(
            [info_bits, np.zeros(kbch - ksig, np.uint8)])
        m = T.bch_parity_matrix(T2FrameSize.SHORT, 12, kbch)
        bch_par = (padded @ m) & 1
        ldpc_info = np.concatenate([padded, bch_par.astype(np.uint8)])
        q = (16200 - nbch) // 360
        rows = T.ldpc_accumulator_rows(0 if nbch == T.L1PRE_NBCH else 1,
                                       16200, nbch)
        npar = 16200 - nbch
        p = np.zeros(npar, dtype=np.uint8)
        for g, addrs in enumerate(rows):
            mm = np.arange(360)
            bits = ldpc_info[g * 360 + mm]
            for a in addrs:
                np.bitwise_xor.at(p, (a + mm * q) % npar, bits)
        p = np.bitwise_xor.accumulate(p)
        # shortening: transmit info (no pad) + BCH parity + kept LDPC parity
        return np.concatenate([info_bits, bch_par.astype(np.uint8),
                               p[:keep_parity]])

    pre_info = T.l1_pre_bits(cfg)
    pre_tx = encode_short(pre_info, T.L1PRE_KBCH, T.L1PRE_NBCH,
                          T.L1PRE_CELLS - T.L1PRE_KSIG - 168)
    assert len(pre_tx) == T.L1PRE_CELLS
    # BPSK cells (pairs)
    pre_cells = np.stack([1.0 - 2.0 * pre_tx.astype(np.float32),
                          np.zeros(len(pre_tx), np.float32)], -1)

    post_info = T.l1_post_bits(cfg)
    keep = 9000 - n_punc
    post_tx = encode_short(post_info, T.L1POST_KBCH, T.L1POST_NBCH, keep)
    assert len(post_tx) == n_post, (len(post_tx), n_post)
    # demux + map like the data path at the L1 constellation
    lut_map = {0: None, 1: T2Constellation.QPSK, 2: T2Constellation.QAM16,
               3: T2Constellation.QAM64}
    if cfg.l1_constellation == 0:
        post_cells = np.stack([1.0 - 2.0 * post_tx.astype(np.float32),
                               np.zeros(len(post_tx), np.float32)], -1)
    else:
        c = lut_map[cfg.l1_constellation]
        v = c.bits_per_symbol
        lut = T.constellation_pairs(c, rotation=False)
        words = post_tx.reshape(-1, v) @ (1 << np.arange(v - 1, -1, -1))
        post_cells = lut[words]
    return dict(pre_cells=pre_cells.astype(np.float32),
                post_cells=post_cells.astype(np.float32),
                n_post=n_post, eta=eta)


# ---------------------------------------------------------------------------
# Frame building (§8.3): cells -> per-symbol carrier grid
# ---------------------------------------------------------------------------

@functools.cache
def _frame_arrays(cfg: Dvbt2Config):
    """Host-side scatter/gather arrays for frame assembly."""
    fp = T.frame_plan(cfg)
    l1 = _l1_plan(cfg)
    p = _plan(cfg)
    K = cfg.carriers
    lf = cfg.frame_symbols
    cnts = fp["data_cnt"]
    total = int(cnts.sum())
    n_l1 = len(l1["pre_cells"]) + len(l1["post_cells"])
    ncells = cfg.cells_per_fec_block
    nb = cfg.fec_blocks
    n_payload = nb * ncells
    n_dummy = total - n_l1 - n_payload
    assert n_dummy >= 0, (total, n_l1, n_payload)
    # dummy cells: BB-PRBS bits BPSK-mapped (§8.3.6.3 behaviour)
    dummy_bits = bb_scrambler_bits(max(n_dummy, 1))[:n_dummy]
    dummy = np.stack([1.0 - 2.0 * dummy_bits.astype(np.float32),
                      np.zeros(n_dummy, np.float32)], -1)
    # Compose (stream split → frequency interleave → data-carrier scatter)
    # into ONE static gather: grid[l, k] = stream[src[l, k]] on data
    # carriers, pilot/zero otherwise.  out[h[j]] = in[j] means the data
    # carrier holding data-cell i reads stream[start_l + hinv[i]].
    h_even, h_odd = T.freq_interleaver_perms(cfg)
    src = np.full((lf, K), -1, dtype=np.int32)
    start = 0
    for l in range(lf):
        c = int(cnts[l])
        h = h_even if l % 2 == 0 else h_odd
        hp = h[h < c]                     # truncated permutation over [0, c)
        hinv = np.empty(c, dtype=np.int32)
        hinv[hp] = np.arange(c, dtype=np.int32)
        src[l, fp["data_idx"][l, :c]] = start + hinv
        start += c
    # Compose the cell interleaver (§6.4) and time interleaver (§6.5) into
    # the same gather: payload stream position s is pre-interleave cell
    # payload_perm[s], so the hot path gathers straight from the mapped
    # cells and never materializes the 2x-traffic intermediate (the
    # standalone cell_time_interleave stage was ~1/3 of the 32K frame cost).
    ci_flat = (np.arange(nb, dtype=np.int64)[:, None] * ncells
               + p["ci_gather"]).reshape(-1)
    ti = np.empty(n_payload, dtype=np.int64)
    nr = ncells // 5
    start_b = 0
    for size in p["ti_sizes"]:
        nc = size * 5
        pidx = np.arange(size * ncells, dtype=np.int64)
        ti[start_b * ncells + pidx] = (start_b * ncells
                                       + (pidx % nc) * nr + pidx // nc)
        start_b += size
    payload_perm = ci_flat[ti]
    src_fused = src.reshape(-1).astype(np.int64).copy()
    in_payload = ((src_fused >= n_l1) & (src_fused < n_l1 + n_payload))
    src_fused[in_payload] = n_l1 + payload_perm[src_fused[in_payload] - n_l1]
    src_fused = src_fused.reshape(lf, K).astype(np.int32)
    # static pilot grid
    grid = np.zeros((lf, K, 2), dtype=np.float32)
    sign = fp["pilot_sign"]
    for l in range(lf):
        idx = fp["sp_idx"][l][fp["sp_valid"][l]]
        grid[l, idx, 0] = fp["amp"][l] * sign[idx]
    # continual pilots on data symbols
    n_p2 = cfg.n_p2
    cp = fp["cp_set"]
    for l in range(n_p2, lf):
        grid[l, cp, 0] = T.CP_AMPLITUDE[cfg.fft_size] * sign[cp]
    return dict(dummy=dummy, src=np.maximum(src, 0),
                src_fused=np.maximum(src_fused, 0),
                data_mask=(src >= 0),
                pilot_grid=grid, cnts=cnts, total=total, lf=lf, K=K)


def _assemble_grid(cfg: Dvbt2Config, payload: jax.Array,
                   src_key: str) -> jax.Array:
    """payload rails [2, n] -> grid rails [2, L_F, K].  The frame gather
    is THE payload-sized materialization of the chain (~2M cells at 32K);
    per-rail gathering keeps the long axis minor (no tile padding)."""
    fa = _frame_arrays(cfg)
    l1 = _l1_plan(cfg)
    stream = jnp.concatenate([
        jnp.asarray(np.ascontiguousarray(l1["pre_cells"].T)),
        jnp.asarray(np.ascontiguousarray(l1["post_cells"].T)),
        payload,
        jnp.asarray(np.ascontiguousarray(fa["dummy"].T))], axis=1)
    lf, K = fa["lf"], fa["K"]
    # one composed gather per rail: grid[:, l, k] = stream[:, src[l, k]]
    vals = jnp.take(stream, jnp.asarray(fa[src_key]).reshape(-1), axis=1)
    mask = jnp.asarray(fa["data_mask"]).reshape(1, -1)
    pilots = np.ascontiguousarray(
        fa["pilot_grid"].reshape(-1, 2).T)             # [2, lf*K]
    grid = jnp.where(mask, vals, jnp.asarray(pilots))
    return grid.reshape(2, lf, K)


def build_frame_grid(cfg: Dvbt2Config, payload: jax.Array) -> jax.Array:
    """PLP payload cells rails [2, n_payload] (already cell/time-
    interleaved) -> carrier grid rails [2, L_F, K] with L1, dummy cells,
    frequency interleaving and pilots."""
    return _assemble_grid(cfg, payload, "src")


def build_frame_grid_fused(cfg: Dvbt2Config, cells: jax.Array) -> jax.Array:
    """Mapped cells rails [2, blocks, ncells] (NOT yet cell/time-
    interleaved) -> carrier grid, with the §6.4/§6.5 interleavers composed
    into the frame gather (bit-identical to cell_time_interleave +
    build_frame_grid; see test_fused_frame_assembly)."""
    return _assemble_grid(cfg, cells.reshape(2, -1), "src_fused")


# ---------------------------------------------------------------------------
# OFDM back end: IFFT + guard interval + P1 preamble (§9.8, §10)
# ---------------------------------------------------------------------------

OUTPUT_SCALE = 0.2          # dvbt2-blade.py:132 final multiply_const


@functools.cache
def _p1_samples(cfg: Dvbt2Config) -> np.ndarray:
    """The 2048-sample P1 preamble, host-precomputed (it is constant).

    Structure per EN 302 755 §9.8 via tx/t2_p1.py: 1K OFDM symbol, the
    384-carrier CDS, DBPSK+scrambled S1/S2 CSS signalling (S1 = T2_SISO,
    S2 field = FFT size with mixed=0), C-A-B guard structure.  Scaled so
    the P1 mean sample power matches the data symbols' (which carry
    ~cfg.carriers unit-power cells into an unnormalized size-fft IFFT
    followed by the OUTPUT_SCALE/sqrt(fft) in grid_to_iq)."""
    from dtv_utils_tpu.tx import t2_p1
    s2 = {1024: 0, 2048: 1, 4096: 2, 8192: 3, 16384: 4, 32768: 5}[
        cfg.fft_size] << 1
    p1 = t2_p1.p1_time(s1=0, s2=s2,
                       mean_power=cfg.carriers / cfg.fft_size)
    return np.stack([p1.real, p1.imag], -1).astype(np.float32)


TR_CELLS = {1024: 10, 2048: 18, 4096: 36, 8192: 72, 16384: 144, 32768: 288}
PAPR_VCLIP = 3.3            # dvbt2-blade.py:53
PAPR_ITERATIONS = 3         # dvbt2-blade.py:54


@functools.cache
def _tr_kernel(cfg: Dvbt2Config) -> np.ndarray:
    """Tone-reservation reference kernels [2, fft, 2]: the time responses of
    an impulse spread over the reserved carrier sets (EN 302 755 §9.6.2 /
    the dvbt2_paprtr_cc algorithm) — row 0 for P2 symbols (tr_p2 set), row 1
    for data/FC symbols (tr_data set).  The sets are the SAME carriers that
    frame_plan excludes from data cells, so the correction energy only ever
    lands on cells a receiver skips.  Positions are annex-H-shaped stand-ins
    of the exact per-FFT TR cell count (dvbt2rate.c:1108-1196): PARITY-RISK
    on positions, not on structure."""
    fft = cfg.fft_size
    K = cfg.carriers
    fp = T.frame_plan(cfg)
    left = (fft - K + 1) // 2
    kerns = []
    for pos in (fp["tr_p2"], fp["tr_data"]):
        full = np.zeros(fft, dtype=np.complex128)
        full[left + np.asarray(pos)] = 1.0
        kern = np.fft.ifft(np.fft.ifftshift(full))  # peak at sample 0
        kern /= kern[0].real                        # unit peak
        kerns.append(np.stack([kern.real, kern.imag], -1))
    return np.stack(kerns).astype(np.float32)


def papr_reduce_tr(cfg: Dvbt2Config, time_syms: jax.Array) -> jax.Array:
    """Iterative clip-and-filter tone reservation on rail-major
    time-domain symbols [2, lf, fft] (vclip 3.3, 3 iterations —
    dvbt2-blade.py:53-54).

    Each iteration finds the peak sample of every symbol and, where its
    magnitude exceeds vclip (relative to RMS), subtracts the circularly
    shifted unit-peak TR kernel scaled by the excess — energy moves onto the
    symbol's reserved carriers only (P2 symbols use the tr_p2 kernel, data
    symbols tr_data), so data cells are untouched (verified by the
    round-trip FFT check in tests/test_dvbt2.py)."""
    kern = _tr_kernel(cfg)                          # [2 kinds, fft, 2]
    kern_r = jnp.asarray(np.ascontiguousarray(kern[..., 0]))
    kern_i = jnp.asarray(np.ascontiguousarray(kern[..., 1]))
    fft = cfg.fft_size
    lf = time_syms.shape[1]
    kind = (jnp.arange(lf) >= cfg.n_p2).astype(jnp.int32)   # 0=P2, 1=data

    def one_iter(x, _):
        xr, xi = x[0], x[1]                         # [lf, fft]
        power = xr ** 2 + xi ** 2
        rms = jnp.sqrt(jnp.mean(power, axis=1, keepdims=True))
        m = jnp.argmax(power, axis=1)               # [lf]
        pr = jnp.take_along_axis(xr, m[:, None], axis=1)[:, 0]
        pi_ = jnp.take_along_axis(xi, m[:, None], axis=1)[:, 0]
        mag = jnp.sqrt(pr ** 2 + pi_ ** 2)
        clip = PAPR_VCLIP * rms[:, 0]
        excess = jnp.maximum(mag - clip, 0.0)
        scale = jnp.where(mag > 0, excess / jnp.maximum(mag, 1e-30), 0.0)
        ar = (pr * scale)[:, None]                  # complex excess [lf, 1]
        ai = (pi_ * scale)[:, None]
        # x -= alpha * roll(kern[kind], m) per symbol (complex mul on rails)
        idx = (jnp.arange(fft)[None, :] - m[:, None]) % fft
        kr = kern_r[kind[:, None], idx]             # [lf, fft]
        ki = kern_i[kind[:, None], idx]
        out_r = xr - (ar * kr - ai * ki)
        out_i = xi - (ar * ki + ai * kr)
        return jnp.stack([out_r, out_i], axis=0), None

    x, _ = jax.lax.scan(one_iter, time_syms, None, length=PAPR_ITERATIONS)
    return x


def grid_to_iq(cfg: Dvbt2Config, grid: jax.Array) -> jax.Array:
    """Carrier grid rails [2, L_F, K] -> one T2 frame of rail-major IQ
    [2, 2048 + L_F*(fft+gi)]: centered IFFT, [tone-reservation PAPR,]
    cyclic prefix, P1 prepend.  Rail-major end-to-end: every
    payload-sized buffer keeps its long axis minor, and the FFT takes
    separate re/im rails (ops/cfft.fft_ri)."""
    from dtv_utils_tpu.ops.cfft import fft_ri, ifftshift_rails
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.carriers
    lf = grid.shape[1]
    left = (fft - K + 1) // 2
    spec = jnp.zeros((2, lf, fft), dtype=jnp.float32)
    spec = spec.at[:, :, left:left + K].set(grid)
    spec = ifftshift_rails(spec)
    tr_, ti_ = fft_ri(spec[0], spec[1], sign=+1)   # unnormalized reverse
    time = jnp.stack([tr_, ti_], axis=0)           # [2, lf, fft]
    if cfg.papr_tr:
        time = papr_reduce_tr(cfg, time)
    sym = jnp.concatenate([time[:, :, fft - gi:], time], axis=2)
    body = sym.reshape(2, -1) * (OUTPUT_SCALE / np.sqrt(fft))
    p1 = jnp.asarray(_p1_samples(cfg).T) * OUTPUT_SCALE      # [2, 2048]
    return jnp.concatenate([p1, body], axis=1)


def modulate_frame(cfg: Dvbt2Config, ts: jax.Array, state: Dvbt2State
                   ) -> tuple[jax.Array, Dvbt2State]:
    """One T2 frame: TS bytes [payload_bytes_per_frame] -> rail-major IQ
    [2, samples_per_frame].

    jit with cfg static: jax.jit(modulate_frame, static_argnums=0).
    """
    bb, state = mode_adapt(cfg, ts, state)
    fec = fec_encode(cfg, bb)
    cells = interleave_and_map(cfg, fec)
    grid = build_frame_grid_fused(cfg, cells)
    return grid_to_iq(cfg, grid), state


@functools.cache
def jit_modulator(cfg: Dvbt2Config):
    return jax.jit(functools.partial(modulate_frame, cfg))


def modulate_stream(cfg: Dvbt2Config, ts: np.ndarray,
                    state: Dvbt2State | None = None):
    """Host convenience: modulate whole T2 frames; returns complex64."""
    from dtv_utils_tpu.core import cplx
    blk = cfg.payload_bytes_per_frame
    assert len(ts) % blk == 0, f"need multiple of {blk} TS bytes"
    if state is None:
        state = init_state(cfg)
    fn = jit_modulator(cfg)
    out = []
    for i in range(len(ts) // blk):
        iq, state = fn(jnp.asarray(ts[i * blk:(i + 1) * blk]), state)
        out.append(cplx.rails_to_np(iq))
    return (np.concatenate(out) if out else np.empty(0, np.complex64)), state


def samples_per_frame(cfg: Dvbt2Config) -> int:
    return 2048 + cfg.frame_symbols * (cfg.fft_size + cfg.guard_samples)
