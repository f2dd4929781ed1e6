"""Sequence-parallel sharding must be bit-identical to the serial stream.

Runs on the virtual 8-device CPU mesh from conftest.py (the driver's
dryrun_multichip exercises the same path)."""

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core import cplx
from dtv_utils_tpu.core.config import (Constellation, CodeRate, DvbtConfig,
                                       GuardInterval, TransmissionMode)
from dtv_utils_tpu.parallel.stream import (derive_state, make_mesh,
                                           sharded_dvbt_modulator)
from dtv_utils_tpu.tx import dvbt as txd

CFG = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=6,
                 constellation=Constellation.QPSK,
                 code_rate=CodeRate.R1_2, guard=GuardInterval.G1_4)


def _ts_blocks(n_blocks, seed=0):
    rng = np.random.default_rng(seed)
    blk = CFG.ts_bytes_per_superframe
    ts = rng.integers(0, 256, size=n_blocks * blk, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def test_derive_state_matches_sequential():
    ts = _ts_blocks(2)
    blk = CFG.ts_bytes_per_superframe
    fn = txd.jit_modulator(CFG)
    _, state_after_0 = fn(jnp.asarray(ts[:blk]), txd.init_state(CFG))
    derived = derive_state(CFG, jnp.asarray(ts[blk - 12 * 188: blk]),
                           jnp.int32(1))
    np.testing.assert_array_equal(np.asarray(derived.outer_carry),
                                  np.asarray(state_after_0.outer_carry))
    np.testing.assert_array_equal(np.asarray(derived.conv_state),
                                  np.asarray(state_after_0.conv_state))
    assert int(derived.packet_phase) == int(state_after_0.packet_phase)


def test_sharded_equals_sequential_8dev():
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should provide 8 CPU devices"
    n_blocks = 8
    ts = _ts_blocks(n_blocks, seed=5)
    blk = CFG.ts_bytes_per_superframe

    want, _ = txd.modulate_stream(CFG, ts)
    want = want.reshape(n_blocks, -1)

    mesh = make_mesh()
    run, in_sharding = sharded_dvbt_modulator(CFG, mesh)
    ts_dev = jax.device_put(jnp.asarray(ts.reshape(n_blocks, blk)),
                            in_sharding)
    got = cplx.rails_to_np(np.asarray(run(ts_dev)), axis=1)  # [L, 2, n]
    np.testing.assert_array_equal(got, want)


def test_batched_equals_sequential():
    from dtv_utils_tpu.parallel.stream import (HALO_PACKETS,
                                               batched_dvbt_modulator)
    n_blocks = 4
    ts = _ts_blocks(n_blocks, seed=9)
    blk = CFG.ts_bytes_per_superframe

    want, _ = txd.modulate_stream(CFG, ts)
    want = want.reshape(n_blocks, -1)

    fn = batched_dvbt_modulator(CFG)
    iq = fn(jnp.asarray(ts.reshape(n_blocks, blk)),
            jnp.zeros(HALO_PACKETS * 188, jnp.uint8), jnp.int32(0))
    got = cplx.rails_to_np(np.asarray(iq), axis=1).reshape(n_blocks, -1)
    np.testing.assert_array_equal(got, want)

    # continuation: second batch starting mid-stream
    ts2 = _ts_blocks(2, seed=10)
    want2, _ = txd.modulate_stream(CFG, np.concatenate([ts, ts2]))
    want2 = want2.reshape(n_blocks + 2, -1)[n_blocks:]
    iq2 = fn(jnp.asarray(ts2.reshape(2, blk)),
             jnp.asarray(ts[-HALO_PACKETS * 188:]), jnp.int32(n_blocks))
    got2 = cplx.rails_to_np(np.asarray(iq2), axis=1).reshape(2, -1)
    np.testing.assert_array_equal(got2, want2)


def test_sharded_j83b_equals_sequential():
    """Bit-identity of the J.83B sequence shard vs modulate_stream, with
    ≥2 superblocks per device so the 427-packet raw-TS halo, the local
    prev-tail path, AND the cross-device quadrant-prefix rotation are all
    exercised (VERDICT r2 item 3).  4-device submesh keeps the CPU cost of
    the 8-superblock serial oracle bounded."""
    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.parallel.stream import sharded_j83b_modulator
    from dtv_utils_tpu.tx import j83b as txq

    cfg = J83bConfig()
    blk = txq.PACKETS_PER_SUPERBLOCK * 188
    n_blocks = 8
    rng = np.random.default_rng(13)
    ts = rng.integers(0, 256, n_blocks * blk, dtype=np.uint8)
    ts[::188] = 0x47

    want, _ = txq.modulate_stream(cfg, ts)
    want = want.reshape(n_blocks, -1)

    mesh = make_mesh(jax.devices()[:4])
    run, in_sharding = sharded_j83b_modulator(cfg, mesh)
    ts_dev = jax.device_put(jnp.asarray(ts.reshape(n_blocks, blk)),
                            in_sharding)
    got = cplx.rails_to_np(np.asarray(run(ts_dev)), axis=1)  # [L, 2, 2n]
    np.testing.assert_array_equal(got, want)


def test_sharded_dvbt2_equals_sequential():
    from dtv_utils_tpu.core.config import Dvbt2Config
    from dtv_utils_tpu.parallel.stream import sharded_dvbt2_modulator
    from dtv_utils_tpu.tx import dvbt2 as txt2

    cfg = Dvbt2Config()                          # 4K blade profile
    blk = cfg.payload_bytes_per_frame
    n_frames = 8
    rng = np.random.default_rng(11)
    ts = rng.integers(0, 256, n_frames * blk, dtype=np.uint8)
    ts[::188] = 0x47

    want, _ = txt2.modulate_stream(cfg, ts)
    want = want.reshape(n_frames, -1)

    mesh = make_mesh()
    run, in_sharding = sharded_dvbt2_modulator(cfg, mesh)
    ts_dev = jax.device_put(jnp.asarray(ts.reshape(n_frames, blk)),
                            in_sharding)
    got = cplx.rails_to_np(np.asarray(run(ts_dev)), axis=1)
    np.testing.assert_array_equal(got, want)


def test_rotate_quadrants_equals_highest_einsum():
    """The rail swap + sign flip equals the 0/±1 rotation-matrix einsum it
    replaced (run at HIGHEST precision), bit for bit, for every k."""
    from dtv_utils_tpu.parallel.stream import rotate_quadrants
    from dtv_utils_tpu.tx import j83b as txq

    rot_mats = np.array([[[1, 0], [0, 1]],
                         [[0, -1], [1, 0]],
                         [[-1, 0], [0, -1]],
                         [[0, 1], [-1, 0]]], dtype=np.float32)
    rng = np.random.default_rng(17)
    words = rng.integers(0, 64, size=(8, 1000))
    cells = jnp.asarray(
        np.moveaxis(txq.CONSTELLATION_64_PAIRS[words], -1, 1))  # [8, 2, n]
    k = jnp.asarray(np.arange(8, dtype=np.int32) * 3)            # all k mod 4
    want = jnp.einsum("lcd,lcn->ldn", jnp.asarray(rot_mats)[k & 3], cells,
                      precision=jax.lax.Precision.HIGHEST)
    got = rotate_quadrants(cells, k)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # and it is the complex product by (−j)^k
    c = cplx.rails_to_np(np.asarray(cells), axis=1)
    np.testing.assert_array_equal(
        cplx.rails_to_np(np.asarray(got), axis=1),
        c * ((-1j) ** (np.arange(8) * 3 % 4))[:, None])
