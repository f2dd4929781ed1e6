"""ITU-T J.83 Annex B 64-QAM cable receiver.

Inverts the tx/j83b.py chain (reference TX: /root/reference/
qam-blade.py:50-79; the reference has no receiver — cable set-top hardware
closes its loop):

  RRC matched filter + symbol-rate downsample (calibrated against the
  interpolator's exact combined response) → nearest-point 64-QAM demap →
  differential quadrant decode → dual 16-state Viterbi (ops/viterbi.py,
  K=5 (25,37) punctured 4/5) → trellis-group reassembly → FSYNC verify +
  strip (control word extracted like a real receiver) → derandomize →
  (I=128, J=4) convolutional de-interleave → RS(128,122)/GF(128) syndrome
  + extension check with t=2 correction → transport de-framing (checksum
  verify, 0x47 restore) → TS.

Alignment contract: the IQ stream starts at a superblock boundary (the
modulator's output contract).  The de-interleaver keeps 65,024 symbols in
flight, so the last ~8.5 FEC frames of a stream stay undecoded — exactly a
hardware receiver's de-interleaver latency.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core.config import J83bConfig
from dtv_utils_tpu.core.galois import GF128, gf2_matmul
from dtv_utils_tpu.ops.rs_decode import RsDecoder
from dtv_utils_tpu.ops.viterbi import (J83B_G1, J83B_G2, J83B_K,
                                       depuncture_xy, viterbi_decode)
from dtv_utils_tpu.tx import j83b as TX


@dataclass
class J83bRxResult:
    ts: np.ndarray            # recovered TS bytes
    fsync_ok: bool            # every frame trailer matched
    control_word: int         # interleaver mode from the trailer (expect 6)
    rs_ok: np.ndarray         # bool [n_cw] codeword decodable
    rs_errors: np.ndarray     # int32 [n_cw] corrected symbol errors
    ext_ok: np.ndarray        # bool [n_cw] extension-symbol check
    checksum_ok: np.ndarray   # bool [n_pkts] transport checksum verified


@functools.cache
def _mf_plan(cfg: J83bConfig) -> dict:
    """Matched-filter calibration: push a unit impulse through the exact TX
    interpolator formulation, correlate with the taps, and measure the
    combined response's peak offset/scale and worst-case residual ISI."""
    taps = TX.rrc_taps(cfg).astype(np.float64)
    nt = len(taps)
    # TX: out[2m + p] = sum_k taps[2k + p] * ext[m + 49 - k] with
    # ext = [49-zero tail, cells], i.e. cell index c = m - k.
    # Impulse at cell index M:
    M = nt  # comfortably inside
    n_cells = 2 * nt + 1
    out = np.zeros(2 * n_cells)
    for m in range(n_cells):
        for p in range(2):
            for k in range(nt // 2):
                if m - k == M:
                    out[2 * m + p] += taps[2 * k + p]
    # RX: y[i] = sum_j taps[j] * out[i + j]  (correlation, zero-pad tail)
    y = np.correlate(out, taps, mode="full")[nt - 1:]
    # symbol estimate for cell m reads y[2m + off]
    resp = y[::1]
    peak_i = int(np.argmax(np.abs(resp)))
    off = peak_i - 2 * M
    scale = resp[peak_i]
    # residual ISI at other symbol instants
    isi = sum(abs(resp[peak_i + 2 * d]) for d in range(-M // 2, M // 2)
              if d != 0 and 0 <= peak_i + 2 * d < len(resp))
    return dict(off=off, scale=float(scale), isi=float(isi / abs(scale)),
                taps=taps.astype(np.float32))


@functools.cache
def _jit_front(cfg: J83bConfig, n_iq: int):
    """IQ pairs [n_iq, 2] -> 6-bit words [n_sym] (MF + demap), jitted."""
    mp = _mf_plan(cfg)
    taps = mp["taps"]
    nt = len(taps)
    lut = jnp.asarray(TX.CONSTELLATION_64_PAIRS)

    def fn(iq):
        x = iq.T                                      # [2, n]
        xp = jnp.pad(x, ((0, 0), (0, nt)))
        # lax.conv_general_dilated computes CORRELATION (no kernel flip),
        # which is exactly the matched filter y[i] = sum_j taps[j]·x[i+j]
        y = jax.lax.conv_general_dilated(
            xp[:, None, :], jnp.asarray(taps)[None, None, :],
            (1,), "VALID", precision=jax.lax.Precision.HIGHEST)[:, 0, :]
        n_sym = n_iq // 2
        idx = 2 * jnp.arange(n_sym) + mp["off"]
        sym = y[:, idx].T / mp["scale"]               # [n_sym, 2]
        d2 = (sym[:, None, 0] - lut[None, :, 0]) ** 2 \
            + (sym[:, None, 1] - lut[None, :, 1]) ** 2
        return jnp.argmin(d2, axis=1).astype(jnp.int32)
    return jax.jit(fn)


@functools.cache
def _jit_trellis_decode(n_sym: int):
    """words [n_sym] -> frame bits [n_sym // 5 * 28] (inverse TCM)."""
    def fn(words):
        u = ((words >> 5) & 1).astype(jnp.uint8)
        v = ((words >> 4) & 1).astype(jnp.uint8)
        W = ((words >> 3) & 1).astype(jnp.uint8)
        ca = ((words >> 2) & 1).astype(jnp.uint8)
        cb = ((words >> 1) & 1).astype(jnp.uint8)
        Z = (words & 1).astype(jnp.uint8)
        # differential quadrant decode: q_out = Gray(W, Z) cumsum of q_in
        q_out = (W.astype(jnp.int32) << 1) | (W ^ Z).astype(jnp.int32)
        q_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), q_out[:-1]])
        q_in = (q_out - q_prev) & 3
        w = (q_in >> 1).astype(jnp.uint8)
        z = (w ^ (q_in & 1).astype(jnp.uint8))
        # dual Viterbi over the coded streams (exact on clean input,
        # error-correcting under noise)
        def vit(c):
            llr = 1.0 - 2.0 * c.astype(jnp.float32)
            pairs = depuncture_xy(llr, TX.PUNCT_X, TX.PUNCT_Y)
            from dtv_utils_tpu.ops.viterbi import seam_overlap
            return viterbi_decode(pairs, block=4096, k=J83B_K,
                                  g1=J83B_G1, g2=J83B_G2,
                                  overlap=seam_overlap(J83B_K, 4, 5))
        ca_in = vit(ca).reshape(-1, 4)                # [n_grp, 4]
        cb_in = vit(cb).reshape(-1, 4)
        n_grp = n_sym // 5
        # substream reassembly (inverse of tx trellis_encode group layout)
        ua = jnp.stack([w.reshape(n_grp, 5), u.reshape(n_grp, 5)],
                       axis=-1).reshape(n_grp, 10)
        ub = jnp.stack([z.reshape(n_grp, 5), v.reshape(n_grp, 5)],
                       axis=-1).reshape(n_grp, 10)
        a = jnp.concatenate([ua, ca_in], axis=1)      # [n_grp, 14]
        b = jnp.concatenate([ub, cb_in], axis=1)
        g = jnp.stack([a, b], axis=-1).reshape(n_grp, 28)
        return g.reshape(-1)
    return jax.jit(fn)


@functools.cache
def _rs_dec() -> RsDecoder:
    """Decoder for the inner (127,122) code (the extension symbol is checked
    separately; see tx/j83b._rs)."""
    return RsDecoder(GF128, k_sym=122, nroots=5, first_root=1)


def demodulate_stream(cfg: J83bConfig, iq: np.ndarray) -> J83bRxResult:
    """IQ (complex64 [n] or float32 pairs [n, 2]) -> recovered TS."""
    if iq.dtype == np.complex64:
        iq = np.stack([iq.real, iq.imag], axis=-1)
    blk = 2 * (TX.FRAMES_PER_SUPERBLOCK * TX.FRAME_BITS // 28) * 5
    assert len(iq) % blk == 0, f"need whole superblocks of {blk} samples"

    words = _jit_front(cfg, len(iq))(jnp.asarray(iq))
    n_sym = len(iq) // 2
    frame_bits = np.asarray(_jit_trellis_decode(n_sym)(words))

    # FSYNC verify + strip per frame.  The stream's FINAL ~2 trellis groups
    # (56 bits) have no continuation evidence, so their Viterbi decisions
    # are undetermined even on clean input — a streaming receiver never
    # sees a "last" frame; its trailer (the last 42 bits of the stream) is
    # excluded from the check.
    fb = frame_bits.reshape(-1, TX.FRAME_BITS)
    sync = fb[:, TX.FRAME_SYMBOLS * 7:]
    want = np.array([(TX.FSYNC_WORD >> (TX.FSYNC_BITS - 1 - i)) & 1
                     for i in range(TX.FSYNC_BITS)], np.uint8)
    fsync_ok = bool(np.array_equal(sync[:-1],
                                   np.tile(want, (len(fb) - 1, 1))))
    cw_field = int("".join(map(str, sync[0, -4:].tolist())), 2) \
        if len(fb) else -1

    # derandomize + de-interleave (full stream, zero initial carry):
    # interleaved[k] = cw[k - I*J*(k % I)]  =>  cw[j] = inter[j + I*J*(j%I)]
    pay = fb[:, :TX.FRAME_SYMBOLS * 7].reshape(-1, 7)
    syms = np.asarray(bitops.bits_to_words(jnp.asarray(pay), 7)).reshape(
        len(fb), TX.FRAME_SYMBOLS)
    rnd = np.tile(TX._randomizer_frame(), (len(fb), 1))
    inter = (syms ^ rnd).reshape(-1)
    total = len(inter)
    max_shift = TX.ILV_I * TX.ILV_J * (TX.ILV_I - 1)
    # tail guard: the final 2 trellis groups' bits (ceil(56/7) = 8 symbols)
    # are inside the Viterbi erasure tail — not yet received, in stream terms
    n_cw = max((total - max_shift - 8) // TX.RS_N, 0)
    j = np.arange(n_cw * TX.RS_N, dtype=np.int64)
    cw = inter[j + TX.ILV_I * TX.ILV_J * (j % TX.ILV_I)].reshape(-1, TX.RS_N)

    # RS: correct up to t=2 on the (127,122) body, verify the extension
    corrected, n_err, ok = _rs_dec().decode_words(jnp.asarray(cw[:, :127]))
    corrected = np.asarray(corrected)
    gf_sum = np.bitwise_xor.reduce(corrected, axis=1)
    ext_ok = gf_sum == cw[:, 127]
    info = corrected[:, :122]

    # transport de-framing: 7-bit symbols -> bytes -> checksum verify
    bits = np.asarray(bitops.words_to_bits(jnp.asarray(info.reshape(-1)), 7))
    n_pkts = len(bits) // 8 // 188
    packed = np.packbits(bits[:n_pkts * 188 * 8]).reshape(n_pkts, 188)
    crc_m = TX._framing_crc_matrix().astype(np.int64)
    pay_bits = np.unpackbits(packed[:, 1:], axis=1).astype(np.int64)
    want_crc = np.packbits((pay_bits @ crc_m) & 1, axis=1)[:, 0]
    checksum_ok = packed[:, 0] == want_crc
    ts = packed.copy()
    ts[:, 0] = 0x47

    return J83bRxResult(
        ts=ts.reshape(-1), fsync_ok=fsync_ok, control_word=cw_field,
        rs_ok=np.asarray(ok), rs_errors=np.asarray(n_err),
        ext_ok=ext_ok, checksum_ok=checksum_ok)
