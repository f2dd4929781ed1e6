"""J.83B chain: JAX vectorized implementation vs independent serial oracle.

The oracle (tests/j83b_serial_ref.py) re-implements every stage with explicit
LFSRs/deques/per-group loops; these tests catch vectorization and indexing
bugs.  Spec-recall risks (constants shared by both) are tracked in PARITY.md.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from dtv_utils_tpu.core import cplx
from dtv_utils_tpu.core.config import J83bConfig
from dtv_utils_tpu.tx import j83b as J
from j83b_serial_ref import SerialJ83b, rrc_polyphase


RNG = np.random.default_rng(0x1383B)


def test_superblock_geometry():
    # 6405 TS packets = 188 FEC frames exactly (no fractional symbols)
    assert J.PACKETS_PER_SUPERBLOCK * 188 * 8 == 188 * J.FRAME_SYMBOLS // \
        J.RS_N * J.RS_K * 7
    total_bits = J.FRAMES_PER_SUPERBLOCK * J.FRAME_BITS
    assert total_bits % J.TRELLIS_GROUP_IN == 0
    assert (total_bits // J.TRELLIS_GROUP_IN * 5) == 1_806_210


def test_rate_identity():
    # 5056941 * 6 * 14/15 * 8960/8967 * 122/128 * 187/188-ish ≈ README:79
    from fractions import Fraction
    sym = Fraction(5_056_941)
    ts_rate = (sym * 6                       # bits/symbol
               * Fraction(28, 30)            # TCM 14/15
               * Fraction(J.FRAME_SYMBOLS * 7, J.FRAME_BITS)   # FSYNC
               * Fraction(J.RS_K, J.RS_N))   # RS
    assert abs(float(ts_rate) - 26_970_352.0) < 1.0


def test_cells_vs_serial_oracle():
    n = J.PACKETS_PER_SUPERBLOCK * 188
    ts = RNG.integers(0, 256, size=n, dtype=np.uint8)
    ts[0::188] = 0x47

    oracle = SerialJ83b()
    want = oracle.modulate_symbols(ts)

    cfg = J83bConfig()
    state = J.init_state(cfg)
    got, _ = J.encode_to_cells(cfg, jnp.asarray(ts), state)
    got = cplx.rails_to_np(got)          # device layout is rail-major
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_interleaver_carry_across_blocks():
    # two consecutive superblock-sized symbol streams == one long serial run
    n = J.FRAME_SYMBOLS * J.FRAMES_PER_SUPERBLOCK
    syms = RNG.integers(0, 128, size=2 * n, dtype=np.int64)

    oracle = SerialJ83b()
    want = oracle.interleave(syms)

    state = J.init_state(J83bConfig())
    out1, carry = J.interleave(jnp.asarray(syms[:n], dtype=jnp.int32),
                               state.ilv_carry)
    out2, _ = J.interleave(jnp.asarray(syms[n:], dtype=jnp.int32), carry)
    got = np.concatenate([np.asarray(out1), np.asarray(out2)])
    np.testing.assert_array_equal(got, want)


def test_trellis_state_across_calls():
    # trellis encoder state (conv regs + differential quadrant) must chain
    n_bits = 28 * 400
    bits = RNG.integers(0, 2, size=2 * n_bits, dtype=np.uint8)

    oracle = SerialJ83b()
    want = oracle.trellis(bits)

    st = J.init_state(J83bConfig())
    w1, ca, cb, dq = J.trellis_encode(jnp.asarray(bits[:n_bits]),
                                      st.conv_a, st.conv_b, st.diff_state)
    w2, _, _, _ = J.trellis_encode(jnp.asarray(bits[n_bits:]), ca, cb, dq)
    got = np.concatenate([np.asarray(w1), np.asarray(w2)])
    np.testing.assert_array_equal(got, want)


def test_rrc_interpolator_vs_serial():
    cfg = J83bConfig()
    taps = J.rrc_taps(cfg)
    assert taps.shape == (100,)
    cells = (RNG.normal(size=600) + 1j * RNG.normal(size=600)).astype(
        np.complex64)

    oracle = SerialJ83b()
    want1 = oracle.rrc(cells[:300], taps)
    want2 = oracle.rrc(cells[300:], taps)

    st = J.init_state(cfg)
    got1, tail = J.rrc_interpolate(
        jnp.asarray(cplx.rails_from_np(cells[:300])), st.rrc_tail, taps)
    got2, _ = J.rrc_interpolate(
        jnp.asarray(cplx.rails_from_np(cells[300:])), tail, taps)
    np.testing.assert_allclose(cplx.rails_to_np(got1), want1, atol=1e-5)
    np.testing.assert_allclose(cplx.rails_to_np(got2), want2, atol=1e-5)


def test_modulate_stream_shapes():
    cfg = J83bConfig()
    n = J.PACKETS_PER_SUPERBLOCK * 188
    ts = RNG.integers(0, 256, size=n, dtype=np.uint8)
    iq, state = J.modulate_stream(cfg, ts)
    assert iq.shape == (2 * 1_806_210,)
    assert iq.dtype == np.complex64
    # output rate identity: 2 samples/symbol at 5.056941 Mbaud
    assert float(cfg.sample_rate) == pytest.approx(10_113_882.0)


@pytest.mark.parametrize("n", [40_001, 4_099])
def test_rrc_interpolator_vs_numpy_polyphase(n):
    """The RRC interpolator against np.convolve at lengths that are no
    multiple of any tile or block size, across a block boundary."""
    cfg = J83bConfig()
    taps = J.rrc_taps(cfg)
    rng = np.random.default_rng(n)
    cells = (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n)).astype(
        np.complex64)
    want = rrc_polyphase(cells, taps)
    st = J.init_state(cfg)
    got1, tail = J.rrc_interpolate(
        jnp.asarray(cplx.rails_from_np(cells[:n])), st.rrc_tail, taps)
    got2, _ = J.rrc_interpolate(
        jnp.asarray(cplx.rails_from_np(cells[n:])), tail, taps)
    got = np.concatenate([cplx.rails_to_np(got1), cplx.rails_to_np(got2)])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
