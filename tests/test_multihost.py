"""Multi-host distributed backend (parallel/multihost.py): a 2-process
gloo CPU "pod" (2 virtual devices each) runs the sequence-sharded DVB-T
chain over the 4-device GLOBAL mesh with host-striped TS ingest, and every
host's local output shards are bit-identical to the serial modulator —
including the carry halo whose ppermute hop crosses the process boundary.
"""

import pathlib
import socket
import subprocess
import sys

import numpy as np

WORKER = pathlib.Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_dvbt_bit_identical(tmp_path):
    from dtv_utils_tpu.core.config import (CodeRate, Constellation,
                                           DvbtConfig, GuardInterval,
                                           TransmissionMode)
    cfg = DvbtConfig(mode=TransmissionMode.M2K, bandwidth_mhz=8,
                     constellation=Constellation.QAM64,
                     code_rate=CodeRate.R3_4, guard=GuardInterval.G1_8)
    n_blocks = 8                       # 2 procs x 2 devices x 2 blocks
    blk = cfg.ts_bytes_per_superframe
    rng = np.random.default_rng(0)
    ts = rng.integers(0, 256, n_blocks * blk, dtype=np.uint8)
    ts[::188] = 0x47
    ts_path = tmp_path / "ts.bin"
    ts_path.write_bytes(ts.tobytes())

    port = str(_free_port())
    env = dict(JAX_PLATFORMS="", PYTHONPATH=str(WORKER.parent.parent))
    import os
    env = {**os.environ, **env}
    # the workers pick their own device count; single-threaded as in
    # conftest.py, since XLA:CPU's multi-threaded FFT is not reproducible
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(pid), "2", port, str(ts_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, (out, err[-3000:])
        assert "MULTIHOST_OK" in out, (out, err[-3000:])
