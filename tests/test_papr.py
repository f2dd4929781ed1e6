"""PAPR analyzer must reproduce reference papr.c stdout byte-for-byte.

Golden files were generated by compiling /root/reference/papr.c unmodified
and running it on the deterministic 4096-sample cfile below.  Also checks
chunked streaming gives identical stats to one-shot (associativity of the
reduction combiners).
"""

import numpy as np
import pytest

from dtv_utils_tpu.analysis import papr

from pathlib import Path

GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def small_cfile(tmp_path_factory):
    path = tmp_path_factory.mktemp("papr") / "small.cfile"
    rng = np.random.default_rng(1234)
    iq = (rng.standard_normal(8192) * 0.25).astype(np.float32)
    iq.tofile(path)
    return str(path)


def _report(path, graph):
    stats = papr.analyze_file(path)
    levels = papr.make_levels(stats.mean_power, stats.papr_db, graph)
    counts = papr.ccdf_counts(path, levels)
    return papr.format_report(stats, counts, graph)


def test_papr_golden(small_cfile):
    assert _report(small_cfile, False) == (GOLDEN / "papr_4096.txt").read_text()


def test_papr_graph_golden(small_cfile):
    assert _report(small_cfile, True) == (GOLDEN / "papr_g_4096.txt").read_text()


def test_papr_chunked_matches_oneshot(small_cfile):
    one = papr.analyze_file(small_cfile)
    many = papr.analyze_file(small_cfile, chunk_complex=777)
    for attr in ("n", "power_sum", "peak", "peak_offset", "real_pos",
                 "real_pos_offset", "real_neg", "real_neg_offset",
                 "imag_pos", "imag_pos_offset", "imag_neg",
                 "imag_neg_offset"):
        assert getattr(one, attr) == getattr(many, attr), attr


def test_papr_power_rounds_each_product():
    """Device power == numpy's separately rounded i*i + q*q everywhere,
    including the samples where a fused multiply-add would round
    differently, and pass 1 reports numpy's first-occurrence peak."""
    import jax
    import jax.numpy as jnp

    raw = np.random.default_rng(0).standard_normal(1 << 21,
                                                   dtype=np.float32)
    i, q = raw[0::2], raw[1::2]
    want = i * i + q * q
    fused = (i.astype(np.float64) ** 2
             + (q * q).astype(np.float64)).astype(np.float32)
    assert np.count_nonzero(fused != want) > 0     # the data can tell them
    power = jax.jit(lambda r, z: papr._power_f32(r[0::2], r[1::2], z))
    np.testing.assert_array_equal(
        np.asarray(power(jnp.asarray(raw), papr.ZERO)), want)
    vals, idxs = papr._pass1_chunk(jnp.asarray(raw), papr.ZERO)
    k = int(np.argmax(want))
    assert int(idxs[0]) == k and float(vals[0]) == float(want[k])
