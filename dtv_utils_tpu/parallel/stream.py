"""Sequence-parallel DVB-T modulation over a device mesh.

The reference has no distributed execution at all (SURVEY.md §2.2: no
MPI/NCCL anywhere; GNU Radio gives it single-host pipeline threading).  This
design shards the *time axis* in contiguous blocks (device d holds
superframes [d*L, (d+1)*L)), and
the chain's tiny streaming state is NOT passed sequentially — every element
of ``DvbtState`` is a pure function of the previous block's raw TS bytes:

  * dispersal packet phase  = (block_index * packets_per_block) mod 8
    (pure arithmetic);
  * outer interleaver carry = last 2244 bytes of RS(dispersal(prev block)) —
    recomputable from the previous block's last 12 packets;
  * conv-coder state        = 6 bits of one RS output byte of the prev block
    (the last outer-interleaved byte), same 12-packet window.

So the only communication is a one-hop ``ppermute`` of a 2256-byte raw halo
per device — everything else is embarrassingly parallel.  The recompute cost
is 12 packets of RS per device versus ~5000 packets of full chain: <0.3%.

This file is the framework's "tensor/sequence parallelism" layer in the
scaling-book sense: mesh axis ``seq``, shardings annotated with shard_map;
the collectives are one-hop ``ppermute``s and one small ``all_gather``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dtv_utils_tpu.core import bits as bitops
from dtv_utils_tpu.core.config import DvbtConfig
from dtv_utils_tpu.core.prbs import dvbt_dispersal_mask
from dtv_utils_tpu.ops.rs import DVBT_RS
from dtv_utils_tpu.ops.interleave import forney_carry_len
from dtv_utils_tpu.tx import dvbt as txd

HALO_PACKETS = 12      # 12·204 = 2448 ≥ 2244-byte interleaver carry


def make_mesh(devices=None, axis: str = "seq") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def derive_state(cfg: DvbtConfig, prev_tail: jax.Array,
                 block_idx: jax.Array) -> txd.DvbtState:
    """Reconstruct the stream state at the start of block ``block_idx`` from
    the previous block's last HALO_PACKETS packets of raw TS bytes.

    prev_tail: uint8 [HALO_PACKETS*188]; block_idx: int32 scalar (global).
    For block 0 the result must be discarded in favour of init_state().
    """
    n_pkt = cfg.rs_blocks_per_superframe
    # dispersal phase of the first halo packet / of our block
    halo_phase = (block_idx * n_pkt - HALO_PACKETS) % 8
    my_phase = (block_idx * n_pkt) % 8

    mask, _ = dvbt_dispersal_mask()
    base = np.tile(mask, (HALO_PACKETS * 188) // len(mask) + 2)
    masks = np.stack([base[ph * 188: ph * 188 + HALO_PACKETS * 188]
                      for ph in range(8)])
    dispersed = prev_tail ^ jnp.asarray(masks)[halo_phase]

    rs_tail = DVBT_RS().encode_bytes(
        dispersed.reshape(HALO_PACKETS, 188)).reshape(-1)
    C = forney_carry_len(txd.OUTER_I, txd.OUTER_M)
    outer_carry = rs_tail[-C:]
    # The last outer-interleaved byte of the previous block is its RS byte
    # n-1-(11*204) = n-2245 (branch 11 of the Forney commutator), which sits
    # at index 2448-2245 = 203 inside this tail; conv state = its bits,
    # most-recent (LSB) first.
    last_byte = rs_tail[HALO_PACKETS * 204 - C - 1]
    conv_state = (last_byte >> jnp.arange(6, dtype=jnp.uint8)) & 1
    return txd.DvbtState(packet_phase=my_phase.astype(jnp.int32),
                         outer_carry=outer_carry,
                         conv_state=conv_state.astype(jnp.uint8))


def sharded_dvbt_modulator(cfg: DvbtConfig, mesh: Mesh, axis: str = "seq"):
    """Build a jit'd function [n_blocks, ts_bytes] → rail-major
    [n_blocks, 2, samples]
    with both axes block-sharded over ``mesh`` along the time dimension.

    n_blocks must be a multiple of the mesh size.  Block 0 starts a fresh
    stream (zero interleaver/coder state), matching modulate_stream.
    """
    n_dev = mesh.shape[axis]
    blk = cfg.ts_bytes_per_superframe
    halo = HALO_PACKETS * 188

    def local_fn(ts_local: jax.Array) -> jax.Array:
        # ts_local: [L, blk] — this device's consecutive? NO: see layout note.
        # Layout: blocks are distributed contiguously: device d holds global
        # blocks [d*L, (d+1)*L).
        L = ts_local.shape[0]
        d = jax.lax.axis_index(axis)

        # halo from the previous device's last block (ring, one hop)
        my_last_tail = ts_local[-1, -halo:]
        prev_tail0 = jax.lax.ppermute(
            my_last_tail, axis,
            [(i, (i + 1) % n_dev) for i in range(n_dev)])
        # previous-block tails for local blocks 1..L-1 are local
        prev_tails = jnp.concatenate(
            [prev_tail0[None], ts_local[:-1, -halo:]], axis=0)   # [L, halo]

        global_idx = d * L + jnp.arange(L, dtype=jnp.int32)
        states = jax.vmap(lambda t, i: derive_state(cfg, t, i))(
            prev_tails, global_idx)
        # block 0 of the whole stream: fresh state
        init = txd.init_state(cfg)
        is_first = (global_idx == 0)
        states = jax.tree.map(
            lambda s, z: jnp.where(
                is_first.reshape((L,) + (1,) * (z.ndim)), z[None], s),
            states, init)

        def one(ts_i, st_i):
            iq, _ = txd.modulate_superframe(cfg, ts_i, st_i)
            return iq
        return jax.vmap(one)(ts_local, states)

    sharded = jax.shard_map(local_fn, mesh=mesh,
                            in_specs=P(axis, None), out_specs=P(axis, None))

    @jax.jit
    def run(ts_blocks: jax.Array) -> jax.Array:
        assert ts_blocks.shape[0] % n_dev == 0
        assert ts_blocks.shape[1] == blk
        return sharded(ts_blocks)

    in_sharding = NamedSharding(mesh, P(axis, None))
    return run, in_sharding


def sharded_dvbt2_modulator(cfg, mesh: Mesh, axis: str = "seq"):
    """DVB-T2 sequence sharding, contiguous-block layout: device d holds
    frames [d*L, (d+1)*L) (same P(axis, None) block sharding as
    sharded_dvbt_modulator — NOT round-robin).

    The T2 chain's stream state is only {packet_phase, prev_tail[187]} —
    the CRC-8 window into the previous frame's raw bytes — so the shard
    halo is a one-hop ppermute of 187 raw bytes and everything else is
    embarrassingly parallel.  Returns (jit fn [n_frames, payload_bytes] →
    [n_frames, samples, 2], input sharding).
    """
    from dtv_utils_tpu.tx import dvbt2 as txt2
    n_dev = mesh.shape[axis]
    blk = cfg.payload_bytes_per_frame

    def local_fn(ts_local: jax.Array) -> jax.Array:
        L = ts_local.shape[0]
        d = jax.lax.axis_index(axis)
        my_last_tail = ts_local[-1, -187:]
        prev_tail0 = jax.lax.ppermute(
            my_last_tail, axis,
            [(i, (i + 1) % n_dev) for i in range(n_dev)])
        prev_tails = jnp.concatenate(
            [prev_tail0[None], ts_local[:-1, -187:]], axis=0)
        global_idx = d * L + jnp.arange(L, dtype=jnp.int32)
        phases = (global_idx * blk) % 188
        is_first = (global_idx == 0)
        prev_tails = jnp.where(is_first[:, None],
                               jnp.zeros_like(prev_tails), prev_tails)

        def one(ts_i, phase_i, tail_i):
            st = txt2.Dvbt2State(packet_phase=phase_i, prev_tail=tail_i)
            iq, _ = txt2.modulate_frame(cfg, ts_i, st)
            return iq
        return jax.vmap(one)(ts_local, phases, prev_tails)

    sharded = jax.shard_map(local_fn, mesh=mesh,
                            in_specs=P(axis, None), out_specs=P(axis, None))

    @jax.jit
    def run(ts_frames: jax.Array) -> jax.Array:
        assert ts_frames.shape[0] % n_dev == 0
        assert ts_frames.shape[1] == blk
        return sharded(ts_frames)

    return run, NamedSharding(mesh, P(axis, None))


J83B_HALO_PACKETS = 427
"""J.83B shard halo: 427 packets = lcm alignment of TS packets (1504 bits),
7-bit symbolization, and RS(128,122) codewords (854 bits) — 427·1504 =
642,208 bits = 752 whole codewords = 96,256 RS output symbols, which covers
the (I−1)·I·J = 65,024-symbol Forney interleaver reach.  A superblock is
exactly 15 such units (6405 = 15·427)."""


def _j83b_conv_consts():
    """Trellis coder memories at every superblock boundary are CONSTANTS:
    the final 28-bit trellis group of a superblock lies entirely inside the
    (constant) 42-bit FSYNC trailer — frame bits % 28 = 14, so groups align
    at 2-frame granularity and the last group is FSYNC bits 14..41.  The
    feed-forward K=5 coder memory is just its last 4 input bits."""
    from dtv_utils_tpu.tx.j83b import _fsync_bits
    grp = _fsync_bits()[-28:]
    a, b = grp[0::2], grp[1::2]
    return (np.ascontiguousarray(a[10:][::-1]),
            np.ascontiguousarray(b[10:][::-1]))


def derive_j83b_ilv_carry(prev_tail: jax.Array) -> jax.Array:
    """Recompute the Forney interleaver carry entering a superblock from the
    previous superblock's last 427 packets of RAW TS bytes: framing → 7-bit
    symbolization → RS — all boundaries align (see J83B_HALO_PACKETS), and
    the carry is the last 65,024 RS output symbols."""
    from dtv_utils_tpu.core import bits as bitops
    from dtv_utils_tpu.tx import j83b as txq
    framed = txq.transport_framing(
        prev_tail.reshape(J83B_HALO_PACKETS, 188)).reshape(-1)
    bits = bitops.bytes_to_bits(framed)
    syms = bitops.bits_to_words(bits.reshape(-1, 7), 7).reshape(-1)
    cw = txq.rs_encode(syms.reshape(-1, txq.RS_K)).reshape(-1)
    C = (txq.ILV_I - 1) * txq.ILV_I * txq.ILV_J
    return cw[-C:].astype(jnp.int32)


def rotate_quadrants(cells: jax.Array, k: jax.Array) -> jax.Array:
    """Rail-major cells [L, 2, n] times (−j)^k[l], per block l.

    A quarter turn is a swap of the rails and a sign flip, so the rotation
    is exact in float32 and needs no matmul:
    k=0 → (x, y), k=1 → (y, −x), k=2 → (−x, −y), k=3 → (−y, x)."""
    k = (k & 3)[:, None]
    x, y = cells[:, 0], cells[:, 1]
    swap = (k & 1) == 1
    re = jnp.where(swap, y, x)
    im = jnp.where(swap, x, y)
    re = jnp.where(k >= 2, -re, re)
    im = jnp.where((k == 1) | (k == 2), -im, im)
    return jnp.stack([re, im], axis=1)


def sharded_j83b_modulator(cfg, mesh: Mesh, axis: str = "seq"):
    """J.83B sequence sharding, contiguous-block layout (device d holds
    superblocks [d*L, (d+1)*L)), bit-identical to modulate_stream.

    Three stream-state couplings, each handled without serialization:
      * interleaver carry — recomputed locally from a one-hop ppermute of
        the previous superblock's 427-packet raw tail (derive_j83b_ilv_carry);
      * trellis coder memories — constants at superblock boundaries
        (_j83b_conv_consts), zeros only for stream block 0;
      * differential precoder — each block encodes with q0=0, then the
        global quadrant prefix (an exclusive scan of per-block quadrant
        sums, all_gather of one int32 per device) is applied as an EXACT
        90°·k rotation of the emitted cells: advancing the precoder state
        by Δ quadrants multiplies every cell by (−j)^Δ (the constellation's
        rotation symmetry, tests/test_j83b_invariants.py), and a quarter
        turn is a rail swap and sign flip (rotate_quadrants), exact in
        float32.
    The RRC filter history is the previous block's last 49 rotated cells —
    local for blocks 1..L−1, one 49-cell ppermute at device boundaries.
    """
    from dtv_utils_tpu.tx import j83b as txq
    n_dev = mesh.shape[axis]
    blk = txq.PACKETS_PER_SUPERBLOCK * 188
    halo = J83B_HALO_PACKETS * 188
    conv_a_const, conv_b_const = _j83b_conv_consts()

    def local_fn(ts_local: jax.Array) -> jax.Array:
        L = ts_local.shape[0]
        d = jax.lax.axis_index(axis)
        global_idx = d * L + jnp.arange(L, dtype=jnp.int32)
        is_first = (global_idx == 0)

        # ---- interleaver carries from raw-TS halos (one-hop ring) ----
        my_last_tail = ts_local[-1, -halo:]
        prev_tail0 = jax.lax.ppermute(
            my_last_tail, axis,
            [(i, (i + 1) % n_dev) for i in range(n_dev)])
        prev_tails = jnp.concatenate(
            [prev_tail0[None], ts_local[:-1, -halo:]], axis=0)
        carries = jax.vmap(derive_j83b_ilv_carry)(prev_tails)
        carries = jnp.where(is_first[:, None], 0, carries)

        conv_a = jnp.where(is_first[:, None], 0,
                           jnp.asarray(conv_a_const)[None]).astype(jnp.uint8)
        conv_b = jnp.where(is_first[:, None], 0,
                           jnp.asarray(conv_b_const)[None]).astype(jnp.uint8)

        # ---- encode every block with q0 = 0 ----
        def one(ts_i, carry_i, ca_i, cb_i):
            st = txq.J83bState(ilv_carry=carry_i, conv_a=ca_i, conv_b=cb_i,
                               diff_state=jnp.zeros(2, jnp.uint8),
                               rrc_tail=jnp.zeros((2, 49), jnp.float32))
            cells, st2 = txq.encode_to_cells(cfg, ts_i, st)   # [2, n]
            w, z = st2.diff_state[0], st2.diff_state[1]
            q_sum = (w.astype(jnp.int32) << 1) | (w ^ z).astype(jnp.int32)
            return cells, q_sum
        cells, q_sums = jax.vmap(one)(ts_local, carries, conv_a, conv_b)
        # cells: rail-major [L, 2, n] — long axis minor (no tile padding)

        # ---- exact quadrant-prefix rotation ----
        local_excl = jnp.cumsum(q_sums) - q_sums            # [L]
        totals = jax.lax.all_gather(jnp.sum(q_sums), axis)  # [n_dev]
        dev_excl = jnp.sum(
            jnp.where(jnp.arange(n_dev) < d, totals, 0))
        cells = rotate_quadrants(cells, local_excl + dev_excl)

        # ---- RRC histories: previous block's last 49 rotated cells ----
        my_last_cells = cells[-1, :, -49:]
        prev_cells0 = jax.lax.ppermute(
            my_last_cells, axis,
            [(i, (i + 1) % n_dev) for i in range(n_dev)])
        tails = jnp.concatenate([prev_cells0[None], cells[:-1, :, -49:]],
                                axis=0)
        tails = jnp.where(is_first[:, None, None], 0.0, tails)

        taps = txq.rrc_taps(cfg)
        def rrc_one(cells_i, tail_i):
            iq, _ = txq.rrc_interpolate(cells_i, tail_i, taps)
            return iq
        return jax.vmap(rrc_one)(cells, tails)    # [L, 2, 2n] rail-major

    sharded = jax.shard_map(local_fn, mesh=mesh,
                            in_specs=P(axis, None), out_specs=P(axis, None))

    @jax.jit
    def run(ts_blocks: jax.Array) -> jax.Array:
        assert ts_blocks.shape[0] % n_dev == 0
        assert ts_blocks.shape[1] == blk
        return sharded(ts_blocks)

    return run, NamedSharding(mesh, P(axis, None))


def batched_dvbt_modulator(cfg: DvbtConfig):
    """Single-device batched modulator: the same carry-derivation trick used
    for sequence sharding, applied to a batch of consecutive superframes in
    ONE dispatch — every block's stream state is recomputed from its
    predecessor's 12-packet tail, so the whole batch vmaps with no serial
    dependency.  This is the serving shape (amortizes dispatch over several
    superframes).

    Returns jit'd fn(ts_blocks [B, blk], prev_tail [12*188], start_idx)
    → iq [B, samples, 2]; for a fresh stream pass start_idx=0 (prev_tail is
    then ignored for block 0).
    """
    halo = HALO_PACKETS * 188

    @jax.jit
    def run(ts_blocks: jax.Array, prev_tail: jax.Array,
            start_idx: jax.Array) -> jax.Array:
        B = ts_blocks.shape[0]
        prev_tails = jnp.concatenate(
            [prev_tail[None], ts_blocks[:-1, -halo:]], axis=0)
        global_idx = start_idx + jnp.arange(B, dtype=jnp.int32)
        states = jax.vmap(lambda t, i: derive_state(cfg, t, i))(
            prev_tails, global_idx)
        init = txd.init_state(cfg)
        is_first = (global_idx == 0)
        states = jax.tree.map(
            lambda s, z: jnp.where(
                is_first.reshape((B,) + (1,) * z.ndim), z[None], s),
            states, init)

        def one(ts_i, st_i):
            iq, _ = txd.modulate_superframe(cfg, ts_i, st_i)
            return iq
        return jax.vmap(one)(ts_blocks, states)

    return run
