"""LFSR / PRBS sequences, precomputed on the host.

Scramblers in every DTV standard are periodic LFSR streams XORed onto data.
On an accelerator the right formulation is: generate the whole (short) period once in
NumPy, then the device-side scrambler is a vectorized XOR with a broadcast
mask — no sequential state on device at all.  Stream phase across sequence
shards reduces to an integer offset carried in the chain state.

Reference behaviors re-expressed here:
  * DVB-T energy dispersal PRBS 1+x^14+x^15, init 100101010000000, restarted
    every 8 TS packets, sync bytes skipped-but-clocked, first sync inverted
    (EN 300 744 §4.3.1; instantiated at /root/reference/dvbt-blade.py:179).
  * DVB-T pilot PRBS w_k: 1+x^2+x^11, all-ones init (EN 300 744 §4.5.2).
  * DVB-T2/S2 BB scrambler 1+x^14+x^15 with init 100101010000000 over each
    BBFRAME (EN 302 755 §5.2.4; /root/reference/dvbt2-blade.py:120).
"""

from __future__ import annotations

import numpy as np


def lfsr_bits(poly_taps: tuple[int, ...], init_bits: np.ndarray,
              length: int, output: str = "last") -> np.ndarray:
    """Fibonacci LFSR output bits.

    ``poly_taps``: register positions (1-based, position 1 = most recent bit,
    i.e. x^i terms of the feedback polynomial) XORed to form the feedback.
    ``init_bits``: register contents, init_bits[0] = position 1.
    ``output``: "last" taps the final register stage (DVB-T pilot PRBS
    schematic, EN 300 744 fig. 11); "feedback" emits the feedback XOR itself
    (the energy-dispersal schematic, EN 300 744 fig. 3 — its serial output is
    the XOR of stages 14 and 15).
    """
    reg = list(int(b) for b in init_bits)
    n = len(reg)
    out = np.empty(length, dtype=np.uint8)
    for i in range(length):
        fb = 0
        for t in poly_taps:
            fb ^= reg[t - 1]
        out[i] = reg[n - 1] if output == "last" else fb
        reg = [fb] + reg[:-1]
    return out


# --------------------------------------------------------------------------
# DVB energy-dispersal PRBS (1 + x^14 + x^15), init "100 101 010 000 000"
# --------------------------------------------------------------------------

_DISPERSAL_INIT = np.array([1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0],
                           dtype=np.uint8)


def dvb_dispersal_prbs_bytes(nbytes: int) -> np.ndarray:
    """First ``nbytes`` bytes of the DVB randomization PRBS (MSB-first)."""
    bits = lfsr_bits((14, 15), _DISPERSAL_INIT, nbytes * 8, output="feedback")
    return np.packbits(bits)


def dvbt_dispersal_mask(packet_len: int = 188,
                        group: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(xor_mask[group*packet_len], sync_override[group*packet_len]).

    The PRBS restarts every ``group`` packets.  The PRBS is clocked during
    sync bytes but its output is NOT applied to them; the first packet's sync
    byte is transmitted inverted (0x47 → 0xB8).  Returns a XOR mask with
    zeros at sync positions plus a value-override array handling the
    inverted-sync convention: out = (in ^ mask), then positions where
    sync_override != 0 are replaced by in ^ sync_override — implemented by
    folding the inversion into the mask: mask[0] = 0xFF so 0x47^0xFF = 0xB8.
    """
    total = packet_len * group
    prbs = dvb_dispersal_prbs_bytes(total - 1)  # clocked continuously
    mask = np.empty(total, dtype=np.uint8)
    mask[1:] = prbs                   # PRBS byte 0 lands after inverted sync
    sync_positions = np.arange(group) * packet_len
    mask[sync_positions] = 0          # PRBS clocked but not applied on syncs
    mask[0] = 0xFF                    # first sync byte inverted: 0x47 → 0xB8
    is_sync = np.zeros(total, dtype=bool)
    is_sync[sync_positions] = True
    return mask, is_sync


# --------------------------------------------------------------------------
# DVB-T pilot / TPS reference PRBS w_k  (1 + x^2 + x^11, all-ones init)
# --------------------------------------------------------------------------

def dvbt_pilot_prbs(n_carriers: int) -> np.ndarray:
    """w_k for carriers k = 0..n_carriers-1 (EN 300 744 §4.5.2)."""
    init = np.ones(11, dtype=np.uint8)
    return lfsr_bits((2, 11), init, n_carriers)


def dvbt_pilot_signs(n_carriers: int) -> np.ndarray:
    """2*(1/2 - w_k) ∈ {+1,-1} as float32."""
    w = dvbt_pilot_prbs(n_carriers).astype(np.float32)
    return 1.0 - 2.0 * w


# --------------------------------------------------------------------------
# DVB-T2 / S2 BB scrambler (same polynomial, restarted per BBFRAME)
# --------------------------------------------------------------------------

def bb_scrambler_bits(nbits: int) -> np.ndarray:
    return lfsr_bits((14, 15), _DISPERSAL_INIT, nbits, output="feedback")
