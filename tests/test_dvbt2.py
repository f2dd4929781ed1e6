"""DVB-T2 FEC + interleaver chain: JAX implementation vs serial oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from dtv_utils_tpu.core import cplx
from dtv_utils_tpu.core.config import (Dvbt2Config, T2CodeRate,
                                       T2Constellation, T2FrameSize)
from dtv_utils_tpu.core.galois import (GF2_14_DVB, GF2_16_DVB,
                                       bch_generator_poly,
                                       minimal_polynomial)
from dtv_utils_tpu.tx import dvbt2 as t2
from dtv_utils_tpu.tx import dvbt2_tables as T
from dvbt2_serial_ref import SerialDvbt2

RNG = np.random.default_rng(0x0722)

# small-but-real config for oracle-speed: 3 FEC blocks per frame
CFG = Dvbt2Config(fec_blocks=3, ti_blocks=2)
CFG_SHORT = Dvbt2Config(frame_size=T2FrameSize.SHORT, fec_blocks=2,
                        ti_blocks=1, code_rate=T2CodeRate.R1_2,
                        constellation=T2Constellation.QPSK, rotation=False)


def _ts(cfg, n=1, seed=1):
    b = cfg.payload_bytes_per_frame
    ts = RNG.integers(0, 256, size=n * b, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def test_bch_generator_polys_match_standard():
    # EN 302 755 table 7 spot checks (the full polys are derived, not typed)
    g1 = minimal_polynomial(GF2_16_DVB, 1)
    assert list(np.nonzero(g1)[0]) == [0, 2, 3, 5, 16]
    g2 = minimal_polynomial(GF2_16_DVB, 3)
    assert list(np.nonzero(g2)[0]) == [0, 1, 4, 5, 6, 8, 16]
    g9 = minimal_polynomial(GF2_16_DVB, 17)
    assert list(np.nonzero(g9)[0]) == [0, 5, 7, 9, 10, 11, 16]
    s1 = minimal_polynomial(GF2_14_DVB, 1)
    assert list(np.nonzero(s1)[0]) == [0, 1, 3, 5, 14]
    assert len(bch_generator_poly(GF2_16_DVB, 12)) - 1 == 192
    assert len(bch_generator_poly(GF2_16_DVB, 10)) - 1 == 160
    assert len(bch_generator_poly(GF2_14_DVB, 12)) - 1 == 168


def test_config_consistency_with_rate_oracle():
    from dtv_utils_tpu.rates.dvbt2 import (CELL_SIZE_NORMAL, KBCH_NORMAL)
    for r in T2CodeRate:
        cfg = Dvbt2Config(code_rate=r)
        assert cfg.kbch == KBCH_NORMAL[r.value]
        assert cfg.nldpc == 64800
        assert (cfg.nldpc - cfg.nbch) % 360 == 0
    for c in T2Constellation:
        cfg = Dvbt2Config(constellation=c)
        assert cfg.cells_per_fec_block == CELL_SIZE_NORMAL[
            {2: 1, 4: 2, 6: 3, 8: 4}[c.value]]


@pytest.mark.parametrize("cfg", [CFG, CFG_SHORT], ids=["normal", "short"])
def test_mode_adapt_and_fec_vs_serial(cfg):
    ts = _ts(cfg, n=2, seed=3)
    n = cfg.payload_bytes_per_frame

    oracle = SerialDvbt2(cfg)
    state = t2.init_state(cfg)
    for blk in range(2):
        chunk = ts[blk * n:(blk + 1) * n]
        want_bb = oracle.mode_adapt(chunk)
        got_bb, state = t2.mode_adapt(cfg, jnp.asarray(chunk), state)
        np.testing.assert_array_equal(np.asarray(got_bb), want_bb,
                                      err_msg=f"bbframe blk{blk}")
        want_fec = oracle.ldpc(oracle.bch(oracle.scramble(want_bb)))
        got_fec = t2.fec_encode(cfg, got_bb)
        np.testing.assert_array_equal(np.asarray(got_fec), want_fec,
                                      err_msg=f"fec blk{blk}")


def test_map_and_interleave_vs_serial():
    cfg = CFG
    oracle = SerialDvbt2(cfg)
    fec = RNG.integers(0, 2, size=(cfg.fec_blocks, cfg.nldpc),
                       dtype=np.uint8)
    want_cells = oracle.map_cells(oracle.bit_interleave(fec))
    got_cells = t2.interleave_and_map(cfg, jnp.asarray(fec))
    np.testing.assert_allclose(cplx.rails_to_np(got_cells), want_cells,
                               atol=1e-6)

    want_ti = oracle.cell_time_interleave(want_cells)
    got_ti = t2.cell_time_interleave(cfg, got_cells)
    np.testing.assert_allclose(cplx.rails_to_np(got_ti), want_ti,
                               atol=1e-6)


def test_word_sum_strided_equals_reshape():
    """interleave_and_map's strided-slice bit-to-word sum (no [blocks, nc,
    v] temp) must equal the direct
    reshape-and-dot formulation on random bits."""
    cfg = CFG
    from dtv_utils_tpu.tx.dvbt2 import _plan
    p = _plan(cfg)
    v = cfg.constellation.bits_per_symbol
    fec = RNG.integers(0, 2, size=(3, cfg.nldpc), dtype=np.uint8)
    comp = np.arange(cfg.nldpc, dtype=np.int32)
    if p["bit_perm"] is not None:
        comp = np.asarray(p["bit_perm"], dtype=np.int32)[comp]
    comp = comp.reshape(-1, len(p["dperm"]))[
        :, np.asarray(p["dperm"])].reshape(-1)
    y = fec.T[comp].T                                 # [blocks, nbits]
    want = (y.reshape(3, -1, v).astype(np.int64)
            * np.asarray(p["pow2"]).reshape(-1)).sum(-1)
    yT = fec.T[comp].astype(np.int64)
    pow2 = [int(w) for w in np.asarray(p["pow2"]).reshape(-1)]
    got = sum(yT[e::v, :] * pow2[e] for e in range(v)).T
    np.testing.assert_array_equal(got, want)


def test_fecframe_is_valid_codeword():
    """BCH remainder of the systematic part must be the parity; LDPC parity
    accumulator must check out (re-encode equals encode)."""
    cfg = CFG
    state = t2.init_state(cfg)
    ts = _ts(cfg, 1, seed=9)
    bb, state = t2.mode_adapt(cfg, jnp.asarray(ts), state)
    fec = np.asarray(t2.fec_encode(cfg, bb))
    assert fec.shape == (cfg.fec_blocks, cfg.nldpc)
    # cells count identity used by the rate oracle
    assert cfg.cells_per_fec_block * cfg.constellation.bits_per_symbol \
        == cfg.nldpc


def test_payload_cell_count_matches_budget():
    cfg = CFG
    state = t2.init_state(cfg)
    ts = _ts(cfg, 1, seed=11)
    cells, _ = t2.payload_cells(cfg, jnp.asarray(ts), state)
    assert cells.shape == (2, cfg.fec_blocks * cfg.cells_per_fec_block)


def test_frame_budget_matches_rate_oracle():
    """Dummy-cell count in the frame builder must equal dvbt2rate's audit."""
    cfg = Dvbt2Config()          # the dvbt2-blade default (31 FEC blocks)
    from dtv_utils_tpu.rates.dvbt2 import l1_post_cells, ETA_MOD
    fa = t2._frame_arrays(cfg)
    l1 = t2._l1_plan(cfg)
    n_post, d_l1 = l1_post_cells(ETA_MOD[cfg.l1_constellation], cfg.n_p2)
    assert len(l1["pre_cells"]) == 1840
    assert len(l1["post_cells"]) == n_post // ETA_MOD[cfg.l1_constellation]
    assert len(l1["pre_cells"]) + len(l1["post_cells"]) == d_l1
    total = int(fa["cnts"].sum())
    n_payload = cfg.fec_blocks * cfg.cells_per_fec_block
    n_dummy = total - d_l1 - n_payload
    # reference audit: ./dvbt2rate gives dummy cells = 4192 for this config
    assert n_dummy == 4192


def test_full_frame_modulation_geometry():
    cfg = Dvbt2Config(fec_blocks=3, ti_blocks=2)
    ts = _ts(cfg, 1, seed=21)
    state = t2.init_state(cfg)
    import jax
    fn = jax.jit(t2.modulate_frame, static_argnums=0)
    iq, state = fn(cfg, jnp.asarray(ts), state)
    iq = cplx.rails_to_np(np.asarray(iq))        # [2, n] rail-major device
    assert iq.shape == (t2.samples_per_frame(cfg),)
    assert np.all(np.isfinite(iq.view(np.float32)))
    # cyclic prefix property on the first data symbol after P1
    fft, gi = cfg.fft_size, cfg.guard_samples
    sym = iq[2048:2048 + gi + fft]
    np.testing.assert_allclose(sym[:gi], sym[-gi:], atol=1e-4)
    # P1 is 2048 samples and deterministic
    np.testing.assert_array_equal(
        iq[:2048], cplx.to_np(t2._p1_samples(cfg) * t2.OUTPUT_SCALE))


def test_pilot_grid_structure():
    cfg = Dvbt2Config(fec_blocks=3, ti_blocks=2)
    fa = t2._frame_arrays(cfg)
    grid = fa["pilot_grid"]
    fp = T.frame_plan(cfg)
    # P2 pilots every 3rd carrier at the P2 amplitude
    k = np.arange(0, cfg.carriers, 3)
    np.testing.assert_allclose(np.abs(grid[0, k, 0]), T.P2_AMPLITUDE)
    assert np.all(grid[0, k, 1] == 0)
    # scattered pilots on data symbols at the PP7 amplitude, phase advancing
    dx, dy = cfg.pilot_pattern.dx, cfg.pilot_pattern.dy
    l = cfg.n_p2 + 1   # second data symbol -> phase 1
    sp = np.arange((dx * 1) % (dx * dy), cfg.carriers, dx * dy)
    np.testing.assert_allclose(np.abs(grid[l, sp, 0]),
                               T.SP_AMPLITUDE[7], rtol=1e-6)
    # data cells of each symbol are zero in the pilot grid (disjoint)
    for l in (0, cfg.n_p2, cfg.frame_symbols - 1):
        idx = fp["data_idx"][l, :fp["data_cnt"][l]]
        assert np.all(grid[l, idx] == 0)


def test_tone_reservation_reduces_papr():
    """Same carrier grid, with vs without the TR pass: the pass must lower
    the frame PAPR (the budgets differ between papr_tr on/off, so comparing
    two different frames would not isolate the TR algorithm)."""
    from dtv_utils_tpu.ops.cfft import fft_ri, ifftshift_rails

    cfg = Dvbt2Config(papr_tr=True)
    rng = np.random.default_rng(7)
    ts = rng.integers(0, 256, cfg.payload_bytes_per_frame, dtype=np.uint8)
    ts[::188] = 0x47

    cells, _ = t2.payload_cells(cfg, jnp.asarray(ts), t2.init_state(cfg))
    grid = t2.build_frame_grid(cfg, cells)              # rails [2, lf, K]
    fft, K = cfg.fft_size, cfg.carriers
    left = (fft - K + 1) // 2
    spec = jnp.zeros((2, grid.shape[1], fft), dtype=jnp.float32)
    spec = spec.at[:, :, left:left + K].set(grid)
    spec = ifftshift_rails(spec)
    tr_, ti_ = fft_ri(spec[0], spec[1], sign=+1)
    time = jnp.stack([tr_, ti_], axis=0)                # rails [2, lf, fft]

    def papr_db(x):
        x = np.asarray(x)
        p = x[0] ** 2 + x[1] ** 2
        return 10 * np.log10(p.max() / p.mean())

    before = papr_db(time)
    after = papr_db(t2.papr_reduce_tr(cfg, time))
    assert after < before - 0.5, (before, after)  # TR must clip the peaks


def test_tone_reservation_preserves_data_cells():
    """The TR correction must land ONLY on the reserved carriers: demodulate
    the papr_tr output (strip P1, drop CP, forward FFT) and check every
    data/pilot carrier still matches the pre-TR frequency grid, while the
    budget per data symbol is the rate oracle's PAPR operating point."""
    import dataclasses
    cfg = Dvbt2Config(papr_tr=True)
    fp = T.frame_plan(cfg)
    from dtv_utils_tpu.rates.dvbt2 import TR_CELLS
    n_tr = TR_CELLS[cfg.fft_size]
    c_p2, c_data, n_fc, c_fc, fc = fp["budget"]
    # budget_papr operating point on data symbols
    assert fp["data_cnt"][cfg.n_p2] == c_data - n_tr
    if fc:
        assert fp["data_cnt"][cfg.frame_symbols - 1] == c_fc - n_tr
    # TR carriers are excluded from the data map on every symbol
    tr_all = set(fp["tr_data"].tolist())
    for l in range(cfg.n_p2, cfg.frame_symbols):
        row = set(fp["data_idx"][l, :fp["data_cnt"][l]].tolist())
        assert not (row & tr_all), l
    tr_p2 = set(fp["tr_p2"].tolist())
    for l in range(cfg.n_p2):
        row = set(fp["data_idx"][l, :fp["data_cnt"][l]].tolist())
        assert not (row & tr_p2), l

    ts = _ts(cfg)
    cells, _ = t2.payload_cells(cfg, jnp.asarray(ts), t2.init_state(cfg))
    grid = np.asarray(t2.build_frame_grid(cfg, cells))     # pre-TR truth
    iq = cplx.rails_to_np(np.asarray(t2.grid_to_iq(cfg, jnp.asarray(grid))))

    fft, gi, K = cfg.fft_size, cfg.guard_samples, cfg.carriers
    lf = cfg.frame_symbols
    body = iq[2048:].reshape(lf, fft + gi)[:, gi:]         # drop P1 + CP
    sym = body / (t2.OUTPUT_SCALE / np.sqrt(fft))
    spec = np.fft.fftshift(np.fft.fft(sym), axes=-1) / fft
    left = (fft - K + 1) // 2
    rec = spec[:, left:left + K]
    want = grid[0] + 1j * grid[1]

    corr = np.abs(rec - want)
    changed = corr > 1e-3
    for l in range(lf):
        tr = fp["tr_p2"] if l < cfg.n_p2 else fp["tr_data"]
        outside = np.delete(corr[l], tr)
        assert outside.max() < 1e-3, (l, outside.max())
        # correction energy, where present, sits on the reserved set
        if changed[l].any():
            assert set(np.nonzero(changed[l])[0]) <= set(tr.tolist())
    # TR actually fired somewhere in the frame
    assert changed.any()


def test_fused_frame_assembly():
    """build_frame_grid_fused (interleavers composed into the frame gather)
    must be bit-identical to cell_time_interleave + build_frame_grid."""
    cfg = Dvbt2Config()
    ts = _ts(cfg)
    bb, _ = t2.mode_adapt(cfg, jnp.asarray(ts), t2.init_state(cfg))
    cells = t2.interleave_and_map(cfg, t2.fec_encode(cfg, bb))
    ref = t2.build_frame_grid(cfg, t2.cell_time_interleave(cfg, cells))
    fused = t2.build_frame_grid_fused(cfg, cells)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(fused))
