"""Multi-host distributed execution (SURVEY §5 "distributed communication
backend" / §7 step 7).

The reference has no distributed layer at all (SURVEY §2.2: no MPI/NCCL —
GNU Radio pipeline threads only).  Here the sequence-parallel design of
parallel/stream.py extends across hosts unchanged: the global mesh's
``seq`` axis spans every chip of every host, device d holds contiguous
time-blocks [d*L, (d+1)*L), and the only cross-device traffic is the
one-hop ``ppermute`` carry halo — at a host boundary that single hop rides
the network (or gloo on CPU), everything else the host's own links.  TS ingest is host-striped:
because blocks are distributed contiguously and ``jax.devices()`` is
process-major, each host's stripe is one contiguous byte range of the
input stream — each host reads only its own range (no host ever
materializes the full stream).

On a GPU cluster: ``initialize()`` is a thin wrapper over
``jax.distributed.initialize`` (coordinator on host 0).  For CI and this
environment, the same code path runs as N localhost CPU processes with
gloo collectives (tests/test_multihost.py proves a 2-process run is
bit-identical to the serial chain, including the cross-process halo hop).
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_devices_per_process: int | None = None):
    """Join the distributed runtime.  Call before any other jax API.

    On CPU (no accelerator / JAX_PLATFORMS=cpu), requests
    ``cpu_devices_per_process`` virtual devices and gloo collectives so
    multi-host topologies are testable on one machine.
    """
    if cpu_devices_per_process is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{cpu_devices_per_process}").strip()
    import jax
    if cpu_devices_per_process is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax


def seq_mesh(axis: str = "seq"):
    """Global mesh over every device of every host, process-major — so the
    block-contiguous layout of parallel/stream.py maps each host to one
    contiguous stripe of the time axis."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def host_block_range(n_blocks: int, mesh, axis: str = "seq"
                     ) -> tuple[int, int]:
    """[start, stop) of the global time-blocks this host must ingest."""
    import jax
    n_dev = mesh.shape[axis]
    assert n_blocks % n_dev == 0, (n_blocks, n_dev)
    per_dev = n_blocks // n_dev
    mine = [i for i, d in enumerate(mesh.devices.ravel())
            if d.process_index == jax.process_index()]
    return mine[0] * per_dev, (mine[-1] + 1) * per_dev


def make_global_blocks(local_blocks: np.ndarray, n_blocks: int,
                       mesh, axis: str = "seq"):
    """Assemble the globally-sharded [n_blocks, block_bytes] array from
    this host's contiguous stripe (host-striped ingest: every host calls
    this with ONLY its own blocks)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis, None))
    shape = (n_blocks,) + tuple(local_blocks.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_blocks), shape)


def local_output(global_out) -> tuple[int, np.ndarray]:
    """(first_global_block, concatenated local output blocks) — each host
    hands its own stripe of IQ onward without gathering the stream."""
    shards = sorted(global_out.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    first = shards[0].index[0].start or 0
    return first, np.concatenate([np.asarray(s.data) for s in shards])
