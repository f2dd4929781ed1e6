"""Metrics duality + checkpoint/resume exactness."""

import io
import json

import numpy as np

from dtv_utils_tpu.core.config import (Constellation, CodeRate, DvbtConfig,
                                       GuardInterval, TransmissionMode)
from dtv_utils_tpu.tx import dvbt as txd
from dtv_utils_tpu.utils import checkpoint, metrics

CFG = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                 constellation=Constellation.QPSK,
                 code_rate=CodeRate.R1_2, guard=GuardInterval.G1_4)


def test_metrics_sinks_constructor_configurable():
    # json_out/human_out are real dataclass fields: per-instance via __init__
    jo, ho = io.StringIO(), io.StringIO()
    m = metrics.Metrics(json_out=jo, human_out=ho)
    m.emit("x", 2, unit="u")
    assert json.loads(jo.getvalue())["value"] == 2
    assert "x = 2 u" in ho.getvalue()


def test_metrics_json_and_human():
    m = metrics.Metrics()
    m.json_out = io.StringIO()
    m.human_out = io.StringIO()
    m.emit("ts_rate", 31.668449, unit="Mbps", config="8MHz 64QAM 7/8")
    rec = json.loads(m.json_out.getvalue())
    assert rec == {"metric": "ts_rate", "value": 31.668449, "unit": "Mbps",
                   "config": "8MHz 64QAM 7/8"}
    assert "ts_rate = 31.668449 Mbps" in m.human_out.getvalue()
    m2 = metrics.Metrics(suppress_human=True)
    m2.json_out = io.StringIO()
    m2.human_out = io.StringIO()
    m2.emit("x", 1)
    assert m2.human_out.getvalue() == ""


def test_checkpoint_resume_mid_stream(tmp_path):
    blk = CFG.ts_bytes_per_superframe
    rng = np.random.default_rng(2)
    ts = rng.integers(0, 256, 4 * blk, dtype=np.uint8)
    ts[::188] = 0x47

    want, _ = txd.modulate_stream(CFG, ts)

    # run 2 blocks, checkpoint, "restart", resume for 2 more
    got1, state = txd.modulate_stream(CFG, ts[:2 * blk])
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, state, kind="dvbt")
    resumed = checkpoint.load_state(path, txd.init_state(CFG), kind="dvbt")
    got2, _ = txd.modulate_stream(CFG, ts[2 * blk:], state=resumed)
    got = np.concatenate([got1, got2])
    np.testing.assert_array_equal(got, want)


def test_checkpoint_rejects_mismatches(tmp_path):
    import pytest
    state = txd.init_state(CFG)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, state, kind="dvbt")
    with pytest.raises(ValueError, match="kind"):
        checkpoint.load_state(path, state, kind="dvbt2")


def test_cli_resume_matches_oneshot(tmp_path):
    """dvbt-mod --save-state / --load-state splices a stream exactly."""
    import subprocess
    import sys
    blk = CFG.ts_bytes_per_superframe
    rng = np.random.default_rng(4)
    ts = rng.integers(0, 256, 2 * blk, dtype=np.uint8)
    ts[::188] = 0x47
    (tmp_path / "a.ts").write_bytes(ts[:blk].tobytes())
    (tmp_path / "b.ts").write_bytes(ts[blk:].tobytes())
    (tmp_path / "ab.ts").write_bytes(ts.tobytes())
    env_args = ["-m", "t2k", "-c", "6", "-C", "qpsk", "-r", "1/2",
                "-g", "1/4"]

    import os
    import pathlib
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1])

    def run(*extra):
        r = subprocess.run(
            [sys.executable, "-m", "dtv_utils_tpu.cli", "dvbt-mod",
             *env_args, *extra], capture_output=True, cwd=tmp_path, env=env)
        assert r.returncode == 0, r.stderr.decode()

    run("-o", "full.iq", str(tmp_path / "ab.ts"))
    run("-o", "p1.iq", "--save-state", "st.npz", str(tmp_path / "a.ts"))
    run("-o", "p2.iq", "--load-state", "st.npz", str(tmp_path / "b.ts"))
    full = (tmp_path / "full.iq").read_bytes()
    spliced = (tmp_path / "p1.iq").read_bytes() + \
        (tmp_path / "p2.iq").read_bytes()
    assert full == spliced


def test_profile_bytes_model():
    """The roofline bytes model is argument+result buffer bytes — a true
    lower bound on memory traffic — not XLA's logical 'bytes accessed'
    (which exceeds physical traffic for gather-heavy stages and would score
    them above 100% of roofline)."""
    import jax.numpy as jnp

    from dtv_utils_tpu.utils import profile

    x = jnp.zeros((1024, 128), jnp.float32)
    idx = jnp.zeros((1024,), jnp.int32)

    def gathery(x, idx):
        return x[idx] + x[idx] + x[idx]        # logical reads 3x the input

    r = profile.profile_fn("gathery", gathery, (x, idx), iters=3)
    in_b = 1024 * 128 * 4 + 1024 * 4
    out_b = 1024 * 128 * 4
    assert r.bytes_io == in_b + out_b
    # logical accounting counts the gather amplification; io must not
    assert r.bytes_xla >= r.bytes_io or r.bytes_xla == 0.0
    if r.roofline_pct is not None:             # accelerators only
        assert r.roofline_pct <= 110.0         # <=100 + timer noise


def test_profile_cli_streams_rows_as_measured(capsys, monkeypatch):
    """`dtv profile -j` must emit each stage row the moment it is measured:
    a run killed mid-chain keeps the measured prefix.
    Fake two-stage chain; assert a row exists after the first stage even
    though the second raises."""
    import jax.numpy as jnp

    from dtv_utils_tpu.utils import profile

    def fake_chain():
        profile.profile_fn("s1", lambda x: x + 1.0,
                           (jnp.zeros(128, jnp.float32),), iters=3)
        raise RuntimeError("chain dies after stage 1")

    monkeypatch.setitem(profile.CHAINS, "fake", fake_chain)
    try:
        profile.cli(["-j", "fake"])
    except RuntimeError:
        pass
    assert profile.ON_REPORT is None          # hook cleaned up on error
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(rows) == 1 and '"profile.fake.s1"' in rows[0]


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_profile_peaks_none_on_cpu():
    from dtv_utils_tpu.utils import profile
    assert profile._peaks() is None


def test_profile_peaks_unknown_gpu_is_an_error(monkeypatch):
    import jax
    import pytest

    from dtv_utils_tpu.utils import profile
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice("gpu", "NVIDIA Mystery")])
    with pytest.raises(ValueError, match="NVIDIA Mystery"):
        profile._peaks()


def test_profile_peaks_h100_found(monkeypatch):
    import jax

    from dtv_utils_tpu.utils import profile
    monkeypatch.setattr(
        jax, "devices",
        lambda *a: [_FakeDevice("gpu", "NVIDIA H100 80GB HBM3")])
    peaks = profile._peaks()
    assert peaks.hbm_bytes == 3.35e12
    assert peaks.int8_ops > peaks.fp32_flops > 0
    assert "datasheet" in peaks.source


def _gf2_dot(a, b):
    import jax
    import jax.numpy as jnp
    acc = jax.lax.dot_general(a, b, (((a.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return (acc & 1).astype(jnp.uint8)


def test_profile_int8_dot_flops_from_jaxpr():
    """8-bit integer dots are counted 2·M·N·K, once per scan iteration;
    float dots are left to the float32 bucket."""
    import jax
    import jax.numpy as jnp

    from dtv_utils_tpu.utils import profile
    a = jnp.ones((5, 16, 32), jnp.int8)
    b = jnp.ones((32, 8), jnp.int8)
    x = jnp.ones((16, 32), jnp.float32)

    def stage(a, b, x):
        bits = jax.lax.scan(lambda c, ai: (c, _gf2_dot(ai, b)), 0, a)[1]
        return bits, x @ x.T
    jaxpr = jax.make_jaxpr(stage)(a, b, x).jaxpr
    assert profile._int8_dot_flops(jaxpr) == 5 * 2 * 16 * 32 * 8


def test_profile_int8_stage_share_at_most_100(monkeypatch):
    """A GF(2) matmul stage scored with a float32 rate far below the CPU's
    and an int8 rate far above it: the int8 dot must go against the int8
    rate, so the share stays at or below 100% (against the float32 rate it
    would be far above)."""
    import jax.numpy as jnp

    from dtv_utils_tpu.utils import profile
    monkeypatch.setattr(profile, "_peaks", lambda: profile.Peaks(
        fp32_flops=1e8, int8_ops=1e18, hbm_bytes=1e18, source="test"))
    a = jnp.ones((64, 4096), jnp.int8)
    b = jnp.ones((4096, 64), jnp.int8)
    r = profile.profile_fn("gf2", _gf2_dot, (a, b), iters=3)
    assert r.int8_flops == 2 * 64 * 4096 * 64
    assert r.flops / 1e8 > 10 * r.ms / 1e3     # the float32 rate overshoots
    assert 0.0 <= r.roofline_pct <= 100.0


def _cache_dir_in_fresh_process(env_dir):
    """The compile-cache dir a fresh process gets after importing the
    package, with JAX_COMPILATION_CACHE_DIR set to env_dir (or unset)."""
    import os
    import pathlib
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    env["PYTHONPATH"] = str(repo)
    r = subprocess.run(
        [sys.executable, "-c",
         "import dtv_utils_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd="/")
    assert r.returncode == 0, r.stderr
    return r.stdout.strip(), repo


def test_compile_cache_honours_env(tmp_path):
    got, _ = _cache_dir_in_fresh_process(str(tmp_path / "x"))
    assert got == str(tmp_path / "x")


def test_compile_cache_defaults_to_checkout():
    got, repo = _cache_dir_in_fresh_process(None)
    assert got == str(repo / ".jax_cache")
