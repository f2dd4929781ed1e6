"""DVB-T modulator (EN 300 744).

Re-expresses the reference transmit chain — the 12-block GNU Radio flowgraph
at /root/reference/dvbt-blade.py:179-210 (energy dispersal → RS(204,188) →
Forney outer interleaver → K=7 punctured convolutional coder → bit / symbol
inner interleavers → QAM map → pilots/TPS → IFFT → cyclic prefix → ×const)
— as ONE jit-compiled array program over a whole superframe:

  * all interleavers are precomputed static gathers;
  * RS parity is an int8 matmul over GF(2) bitplanes;
  * the convolutional coder is a handful of shifted XORs;
  * 272 OFDM symbols IFFT as one batched FFT.

Streaming state across superframes is a tiny pytree (dispersal packet phase,
outer-interleaver tail, 6 bits of coder memory) — every element is a pure
function of the *input* TS stream, which is what makes the time axis
shardable (parallel/stream.py).

Output amplitude matches the reference convention: unnormalized (FFTW-style)
inverse FFT scaled by 0.0022097087 (dvbt-blade.py:187-189; the script uses
this constant for every mode/constellation).

IQ is float32 re/im reals: (re, im) pairs [..., 2] mid-chain, rail-major
[2, n] for the FFT working set and the materialized output (core/cplx.py
explains the two layouts), with the IFFT batched over symbols
(ops/cfft.fft_ri).
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

from dtv_utils_tpu.core.prbs import dvbt_dispersal_mask
from dtv_utils_tpu.ops.interleave import forney_carry_len
from dtv_utils_tpu.ops.rs import DVBT_RS
from dtv_utils_tpu.tx import dvbt_tables as T

OUTPUT_SCALE = 0.0022097087      # dvbt-blade.py:189
OUTER_I, OUTER_M = 12, 17        # dvbt-blade.py:181


@jax.tree_util.register_dataclass
@dataclass
class DvbtState:
    """Carry-state between consecutive TS blocks (superframes)."""
    packet_phase: jax.Array   # int32 scalar: packets into the 8-pkt PRBS group
    outer_carry: jax.Array    # uint8 [2244]: Forney interleaver tail
    conv_state: jax.Array     # uint8 [6]: last 6 interleaved-stream bits


def init_state(cfg: DvbtConfig) -> DvbtState:
    del cfg
    return DvbtState(
        packet_phase=jnp.zeros((), jnp.int32),
        outer_carry=jnp.zeros(forney_carry_len(OUTER_I, OUTER_M), jnp.uint8),
        conv_state=jnp.zeros(6, jnp.uint8),
    )


@functools.cache
def _plan(cfg: DvbtConfig):
    """All static tables for one config (host NumPy, cached)."""
    n_pkt = cfg.rs_blocks_per_superframe
    v = cfg.constellation.bits_per_symbol
    n_cells = cfg.cells_per_superframe
    mask, _ = dvbt_dispersal_mask()
    # dispersal mask for every possible packet phase (gcd stepping covers
    # only a subset at runtime, but 8 rows is nothing)
    total = n_pkt * 188
    masks = np.empty((8, total), dtype=np.uint8)
    base = np.tile(mask, total // len(mask) + 2)
    for ph in range(8):
        masks[ph] = base[ph * 188: ph * 188 + total]
    del n_cells
    # puncture: small per-period column selector (serial order: X_i then Y_i)
    from dtv_utils_tpu.ops.convcode import PUNCTURE_PATTERNS
    xp, yp = PUNCTURE_PATTERNS[cfg.code_rate.value]
    keep_cols = []
    for i in range(len(xp)):
        if xp[i]:
            keep_cols.append(2 * i)
        if yp[i]:
            keep_cols.append(2 * i + 1)
    even_idx, odd_idx = T.symbol_interleaver_gather(cfg.mode)
    lut = np.stack([T.constellation_lut(cfg.constellation).real,
                    T.constellation_lut(cfg.constellation).imag],
                   axis=-1).astype(np.float32)
    plan_c = T.carrier_plan(cfg)
    demux_pos = np.argsort(np.asarray(T.DEMUX[v]))

    # ---- inner coding as ONE generator-matrix matmul --------------------
    # Conv-encode + puncture + demux + bit-interleaver roll compose to a
    # GF(2)-linear, periodic map from input bits to cell bit-planes: over a
    # period of P cells the whole thing is cells = (window @ B) mod 2 for a
    # small binary matrix B — one integer matmul (each output bit is the
    # XOR of the G1/G2 taps of one input step).  P = lcm(126, K/gcd(v,K)).
    from dtv_utils_tpu.ops.convcode import G1_TAPS, G2_TAPS
    per = len(xp)
    n_keep = len(keep_cols)
    g = int(np.gcd(v, n_keep))
    R = n_keep // g
    n_cells = cfg.cells_per_superframe
    P = int(np.lcm(T.BIT_ILV_BLOCK, R))
    assert n_cells % P == 0 and (v * P) % n_keep == 0, (n_cells, P)
    S_bits = per * (v * P // n_keep)
    max_c = 0
    entries = []     # (c, column) pairs with column = u*v + e
    for u in range(P):
        blk_base = (u // T.BIT_ILV_BLOCK) * T.BIT_ILV_BLOCK
        for e in range(v):
            # H_e roll baked in: plane e of cell u reads demuxed stream cell
            u2 = blk_base + ((u % T.BIT_ILV_BLOCK) + T.BIT_ILV_OFFSETS[e]) \
                % T.BIT_ILV_BLOCK
            s0 = v * u2 + int(demux_pos[e])
            col = keep_cols[s0 % n_keep]
            step, which = col // 2, col % 2
            base = per * (s0 // n_keep) + step
            taps = G1_TAPS if which == 0 else G2_TAPS
            for j in taps:
                c = 6 + base - j
                max_c = max(max_c, c)
                entries.append((c, u * v + e))
    W = max_c + 1
    assert W - S_bits < S_bits   # window overlap fits one extra row
    B = np.zeros((W, P * v), dtype=np.int8)
    for c, colm in entries:
        B[c, colm] ^= 1

    # ---- composed symbol-interleave + pilot/TPS gather ------------------
    # carriers[l, k] = lut[words[l, comp_idx[l%4, k]]] on data positions,
    # else static_vals[l, k]: one gather per pilot phase instead of the
    # two-stage interleave → concat → gather.
    n_data = plan_c.n_data
    comp_idx = np.zeros((4, cfg.mode.carriers), dtype=np.int32)
    data_mask = np.zeros((4, cfg.mode.carriers), dtype=bool)
    perms = (even_idx, odd_idx)
    for ph in range(4):
        gi = plan_c.gidx[ph]
        m = gi < n_data
        data_mask[ph] = m
        comp_idx[ph][m] = perms[ph % 2][gi[m]]
    static_vals = np.zeros(
        (cfg.symbols_per_superframe, cfg.mode.carriers, 2), np.float32)
    for l in range(cfg.symbols_per_superframe):
        ph = l % 4
        sv = plan_c.static_cells[l][plan_c.gidx[ph][~data_mask[ph]] - n_data]
        static_vals[l][~data_mask[ph], 0] = sv.real
        static_vals[l][~data_mask[ph], 1] = sv.imag

    return dict(
        masks=masks,
        gen_B=B,
        gen_P=P,
        gen_S=S_bits,
        gen_W=W,
        lut=lut,
        comp_idx=comp_idx,
        data_mask=data_mask,
        static_vals=static_vals,
    )


def encode_to_carriers(cfg: DvbtConfig, ts: jax.Array,
                       state: DvbtState) -> tuple[jax.Array, DvbtState]:
    """Stages 1-8 (dispersal … pilot/TPS assembly): ts uint8
    [ts_bytes_per_superframe] → carrier grid complex64 [272, K] + next state.
    """
    p = _plan(cfg)
    n_pkt = cfg.rs_blocks_per_superframe
    v = cfg.constellation.bits_per_symbol
    n_sym = cfg.symbols_per_superframe
    n_data = cfg.mode.data_carriers

    # 1. energy dispersal — one XOR with the phase-selected PRBS mask
    dispersed = ts ^ jnp.asarray(p["masks"])[state.packet_phase % 8]
    new_phase = (state.packet_phase + n_pkt) % 8

    # 2. RS(204,188) — bit-matmul per packet
    pkts = dispersed.reshape(n_pkt, 188)
    coded = DVBT_RS().encode_bytes(pkts).reshape(n_pkt * 204)

    # 3. outer (Forney) convolutional interleaver, shear form: with
    # ext = carry ++ coded viewed [*, 12], out2d[r, b] = ext2d[r + C/12 -
    # 17b, b] — run on the TRANSPOSED [12, *] layout where every branch is
    # a contiguous row (one relayout transpose + a vmapped contiguous
    # dynamic_slice, instead of 12 lane-strided slices).
    C = state.outer_carry.shape[0]
    # dynamic_slice clamps negative starts silently; every branch start
    # C/12 - 17b must be >= 0, which needs C >= I*M*(I-1) (ADVICE r4).
    assert C // OUTER_I >= OUTER_M * (OUTER_I - 1)
    ext = jnp.concatenate([state.outer_carry, coded])
    n_bytes = n_pkt * 204
    rows = n_bytes // OUTER_I
    extT = ext.reshape(-1, OUTER_I).T                  # [12, C/12 + rows]
    # static per-branch slices (starts are Python ints, so no dynamic-slice
    # lowering — see tx/j83b.py interleave)
    branches = jnp.stack(
        [jax.lax.slice(extT, (b, C // OUTER_I - OUTER_M * b),
                       (b + 1, C // OUTER_I - OUTER_M * b + rows))[0]
         for b in range(OUTER_I)])                     # [12, rows]
    outer = branches.T.reshape(n_bytes)
    new_outer_carry = ext[-C:]

    # 4+5. inner coder + puncture + demux + bit interleave as ONE int8
    # matmul over GF(2): cell bit-planes = (windows @ B) & 1, where windows
    # is the bit stream viewed as overlapping [M, W] rows (two aligned
    # reshapes — no gathers) and B is the tiny precomputed generator matrix.
    dbits = bitops.bytes_to_bits(outer)
    new_conv_state = dbits[-6:][::-1]                  # most recent first
    n_cells = cfg.cells_per_superframe
    P, S, W = p["gen_P"], p["gen_S"], p["gen_W"]
    M = n_cells // P
    d_ext = jnp.concatenate([state.conv_state[::-1].astype(jnp.uint8),
                             dbits])
    A = jnp.pad(d_ext, (0, S * (M + 1) - d_ext.shape[0]))
    head = A[:S * M].reshape(M, S)
    tail = A[S:S * (M + 1)].reshape(M, S)[:, :W - S]
    windows = jnp.concatenate([head, tail], axis=1).astype(jnp.int8)
    planes = jnp.matmul(windows, jnp.asarray(p["gen_B"]),
                        preferred_element_type=jnp.int32) & 1
    pl = planes.reshape(M, P, v)                       # [M, P, e]
    words = pl[:, :, 0]
    for e in range(1, v):
        words = (words << 1) | pl[:, :, e]
    words = words.reshape(n_cells)

    # 6-8. symbol interleave + QAM map + pilots/TPS as ONE gather per pilot
    # phase: carriers[l,k] = lut[words[l, comp_idx[l%4,k]]] on data cells,
    # else the precomputed static (pilot/TPS) value.  The gather runs on a
    # TRANSPOSED [n_data, n_sym/4] layout so each index pulls a contiguous
    # row (a minor-axis gather reads a cache line per element — it was 85%
    # of the chain's bytes before this).
    lut = jnp.asarray(p["lut"])
    words4 = words.reshape(n_sym // 4, 4, n_data)
    wT = jnp.transpose(words4, (1, 2, 0))              # [4, n_data, n_sym/4]
    rows = []
    for ph in range(4):
        idx = jnp.asarray(p["comp_idx"][ph])
        rows.append(jnp.take(wT[ph], idx, axis=0))     # [K, n_sym/4]
    gathered = jnp.stack(rows, axis=0)                 # [4, K, n_sym/4]
    data_part = lut[jnp.transpose(gathered, (2, 0, 1))].reshape(n_sym, -1, 2)
    mask = jnp.asarray(p["data_mask"])                 # [4, K]
    mask_sym = jnp.tile(mask, (n_sym // 4, 1))[:, :, None]
    carriers = jnp.where(mask_sym, data_part, jnp.asarray(p["static_vals"]))

    return carriers, DvbtState(packet_phase=new_phase,
                               outer_carry=new_outer_carry,
                               conv_state=new_conv_state)


def carriers_to_iq(cfg: DvbtConfig, carriers: jax.Array) -> jax.Array:
    """Stages 9-10: carrier grid [n_sym, K, 2] → rail-major IQ
    [2, n_sym * (fft + guard)].

    Rail-major output (the long axis minor); pairs remain the host format
    via cplx.rails_to_np."""
    from dtv_utils_tpu.ops.cfft import fft_ri, ifftshift_rails
    fft = cfg.fft_size
    gi = cfg.guard_samples
    K = cfg.mode.carriers
    n_sym = carriers.shape[0]
    # center carriers (zeros_on_left = ceil((fft-K)/2), as gr-dtv lays out);
    # rails from here on so the FFT working set and output keep the long
    # axis minor
    rails = jnp.moveaxis(carriers, -1, 0)              # [2, n_sym, K]
    left = (fft - K + 1) // 2
    spec = jnp.zeros((2, n_sym, fft), dtype=jnp.float32)
    spec = spec.at[:, :, left:left + K].set(rails)
    # unnormalized inverse FFT (FFTW convention of fft.fft_vcc, shift=True)
    spec = ifftshift_rails(spec)
    tr_, ti_ = fft_ri(spec[0], spec[1], sign=+1)
    time = jnp.stack([tr_, ti_], axis=0)               # [2, n_sym, fft]
    sym_out = jnp.concatenate([time[:, :, fft - gi:], time], axis=2)
    return (sym_out * OUTPUT_SCALE).reshape(2, -1)


def modulate_superframe(cfg: DvbtConfig, ts: jax.Array,
                        state: DvbtState) -> tuple[jax.Array, DvbtState]:
    """One superframe: ts uint8 [ts_bytes_per_superframe] → rail-major IQ
    float32 [2, 272 * (fft + guard)], plus the next stream state.

    jit with cfg static: ``jax.jit(modulate_superframe, static_argnums=0)``.
    """
    carriers, new_state = encode_to_carriers(cfg, ts, state)
    return carriers_to_iq(cfg, carriers), new_state


@functools.cache
def jit_modulator(cfg: DvbtConfig):
    return jax.jit(functools.partial(modulate_superframe, cfg))


def modulate_stream(cfg: DvbtConfig, ts: np.ndarray,
                    state: DvbtState | None = None,
                    ) -> tuple[np.ndarray, DvbtState]:
    """Host convenience: modulate any whole number of superframes.

    Returns complex64 (host view of the device pair arrays)."""
    blk = cfg.ts_bytes_per_superframe
    assert len(ts) % blk == 0, f"need multiple of {blk} TS bytes"
    if state is None:
        state = init_state(cfg)
    fn = jit_modulator(cfg)
    out = []
    for i in range(len(ts) // blk):
        iq, state = fn(jnp.asarray(ts[i * blk:(i + 1) * blk]), state)
        out.append(cplx.rails_to_np(iq))
    return np.concatenate(out) if out else np.empty(0, np.complex64), state
