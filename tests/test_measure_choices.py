"""tools/measure_choices.py's candidate forms compute what the kept forms
compute, so the times it records compare like with like."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dtv_utils_tpu.analysis import papr
from dtv_utils_tpu.core.config import J83bConfig
from dtv_utils_tpu.ops import cfft
from dtv_utils_tpu.tx import j83b as txq

_PATH = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "measure_choices.py"
_spec = importlib.util.spec_from_file_location("measure_choices", _PATH)
mc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mc)


@pytest.mark.parametrize("n", [128, 2048])         # one step, four steps
@pytest.mark.parametrize("sign", [-1, +1])
def test_matmul_dft_matches_fft_ri(n, sign):
    rng = np.random.default_rng(n)
    xr = rng.standard_normal((3, n), dtype=np.float32)
    xi = rng.standard_normal((3, n), dtype=np.float32)
    want = (np.fft.fft if sign < 0 else
            lambda x: np.fft.ifft(x) * n)(xr + 1j * xi.astype(np.float64))
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    for fft in (mc.matmul_dft_ri, cfft.fft_ri):
        gr, gi = fft(jnp.asarray(xr), jnp.asarray(xi), sign)
        err = np.abs(np.asarray(gr) + 1j * np.asarray(gi) - want).max()
        assert err / rms < 1e-5


def test_rrc_conv_matches_rrc_interpolate():
    taps = txq.rrc_taps(J83bConfig())
    rng = np.random.default_rng(3)
    cells = jnp.asarray(rng.standard_normal((2, 1000), dtype=np.float32))
    tail = jnp.asarray(rng.standard_normal((2, 49), dtype=np.float32))
    want = np.asarray(txq.rrc_interpolate(cells, tail, taps)[0])
    got = np.asarray(jax.jit(lambda c, t: mc.rrc_conv(c, t, taps))(
        cells, tail))
    assert got.shape == want.shape == (2, 2000)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_barrier_power_is_the_papr_power():
    raw = np.random.default_rng(4).standard_normal(4096, dtype=np.float32)
    got = np.asarray(jax.jit(mc.barrier_power)(jnp.asarray(raw)))
    kept = np.asarray(papr._power_f32(jnp.asarray(raw[0::2]),
                                      jnp.asarray(raw[1::2]), papr.ZERO))
    np.testing.assert_allclose(got, kept, rtol=1e-6)
