"""Benchmarks for all four BASELINE.md north-star metrics, one JSON line
each (emitted through utils.metrics so the JSON/human duality is the same
as the model CLIs):

  1. dvbt_8k_qam64_r78_iq_throughput   (the headline, printed first)
  2. papr_scan_throughput              (GSa/s, FULL two-pass tool)
  3. j83b_qam64_iq_throughput
  4. dvbt2_32k_bbc_iq_throughput       (BBC 40.2 Mbps mux, README:149-151)

Runner: phase 1 runs all metrics in ONE subprocess; phase 2 retries
anything missing in isolated per-metric subprocesses with hard budgets.
The parent STREAMS child stdout line-by-line, so a budget kill loses
nothing already printed.  Each child emits its metric after warmup + the
FIRST timed segment (quality="provisional", segments_completed=1), then
keeps refining and RE-EMITTING while its deadline allows (up to
MAX_SEGMENTS); the LAST line per metric is the best estimate.  Timestamped
heartbeats go to stderr at every phase.  Each line carries the raw
per-segment values (`runs`) and `spread_pct`.

Timing: every timed segment ends in ``jax.block_until_ready`` on its
outputs and stream states; inputs are made resident before the segment
starts.  The children run only on a GPU (``_require_gpu``): a number from
any other backend is never printed under a device metric's name.

Serving shape for the modulators: dvbt and j83b run 4 independent muxes
round-robin, one block per dispatch; dvbt2 runs L consecutive frames per
dispatch (parallel/stream's carry-derivation batching — every block's
stream state is recomputed in-dispatch from its predecessor's raw tail,
so a batch has no serial dependency).  The per-bench L is recorded in the
metric's `blocks_per_dispatch` field.

vs_baseline for the modulators is the reference's implied real-time floor:
the bladeRF sample rate each chain must sustain (dvbt-blade.py:146 →
9.142857 Msps for 8 MHz DVB-T/T2; qam-blade.py:36 → 10.113882 Msps for
J.83B).  Values >> 1 mean one chip can modulate that many simultaneous
full-rate muxes.  For papr, vs_baseline is vs 1 GSa/s (papr.c publishes no
number; its two-pass CPU loop is far below that).
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

DVBT_FLOOR_MSPS = 8e6 * 8 / 7 / 1e6      # 9.142857 Msps (dvbt-blade.py:146)
J83B_FLOOR_MSPS = 5.056941 * 2           # 10.113882 Msps (qam-blade.py:36)

# Per-bench wall budgets (seconds), covering compile + transfer + timing.
ORDER = ("dvbt", "papr", "j83b", "dvbt2")
TIMEOUTS = {"dvbt": 150, "papr": 120, "j83b": 150, "dvbt2": 200}
PHASE1_BUDGET = 900.0
MAX_SEGMENTS = 5
# Stop refining when remaining time < last segment cost * this + slack:
# a deadline overrun loses nothing (lines already printed) but wastes the
# next bench's start.
SEG_SAFETY, SEG_SLACK_S = 1.6, 5.0

_T0 = time.perf_counter()


def _hb(name: str, phase: str) -> None:
    """Timestamped heartbeat so a budget kill is attributable to a phase."""
    print(f"[hb {name} +{time.perf_counter() - _T0:7.1f}s] {phase}",
          file=sys.stderr, flush=True)


def _require_gpu() -> None:
    """Measure on a GPU or not at all: no fallback to another backend."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, found platform "
                         f"{dev.platform!r} ({dev.device_kind})")


def _emit(metrics, name, per_segment, unit, floor, **extra):
    med = statistics.median(per_segment)
    spread = (max(per_segment) - min(per_segment)) / med * 100
    n = len(per_segment)
    metrics.emit(name, round(med, 3), unit=unit,
                 vs_baseline=round(med / floor, 3),
                 runs=[round(v, 3) for v in per_segment],
                 spread_pct=round(spread, 1),
                 segments_completed=n,
                 quality="provisional" if n == 1 else "final", **extra)


def _deadline_segments(metrics, name, fn, make_round_inputs, states,
                       samples_per_round, rounds_per_segment, floor,
                       deadline, unit="Msamples/s/chip", scale=1e6,
                       warmup_rounds=1, **extra):
    """Deadline-driven fail-open measurement loop.

    Runs ``fn(input, state)`` round-robin over ``states``, one input per
    dispatch, and ends every timed segment with ``jax.block_until_ready``.
    After warmup and after EVERY completed segment the metric is
    (re-)emitted, so a budget kill can only lose refinement, never the
    number.  ``make_round_inputs(r)`` returns the inputs for round r
    (len(states) of them), made resident OUTSIDE timed regions.
    """
    import jax

    n_streams = len(states)
    _hb(name, "warmup/compile start")
    r = 0
    for _ in range(warmup_rounds):
        inputs = jax.block_until_ready(make_round_inputs(r))
        _hb(name, "warmup inputs resident; dispatching (compile happens "
                  "here on first round)")
        outs = []
        for s in range(n_streams):
            out, states[s] = fn(inputs[s], states[s])
            outs.append(out)
        jax.block_until_ready((outs, states))
        r += 1
    _hb(name, "compiled + warm")
    seg_dts = []
    while len(seg_dts) < MAX_SEGMENTS:
        seg_inputs = jax.block_until_ready(
            [make_round_inputs(r + i) for i in range(rounds_per_segment)])
        r += rounds_per_segment
        _hb(name, f"segment {len(seg_dts) + 1}: buffers resident")
        outs = []
        t0 = time.perf_counter()
        for ins in seg_inputs:
            for s in range(n_streams):
                out, states[s] = fn(ins[s], states[s])
                outs.append(out)
        jax.block_until_ready((outs, states))
        dt = time.perf_counter() - t0
        seg_dts.append(dt)
        per_seg = [rounds_per_segment * samples_per_round / d / scale
                   for d in seg_dts]
        _emit(metrics, name, per_seg, unit, floor, **extra)
        _hb(name, f"segment {len(seg_dts)} done in {dt:.2f}s")
        left = deadline - time.perf_counter()
        if left < dt * SEG_SAFETY + SEG_SLACK_S:
            _hb(name, f"stopping: {left:.1f}s left < "
                      f"{dt * SEG_SAFETY + SEG_SLACK_S:.1f}s needed")
            break


def _ts_block(rng, shape) -> np.ndarray:
    ts = rng.integers(0, 256, size=shape, dtype=np.uint8)
    ts[..., ::188] = 0x47
    return ts


def bench_dvbt(metrics, deadline) -> None:
    import jax
    from dtv_utils_tpu.core.config import (CodeRate, Constellation,
                                           DvbtConfig, GuardInterval,
                                           TransmissionMode)
    from dtv_utils_tpu.tx import dvbt as txd
    _hb("dvbt", "imports done")

    # Serving shape: 4 independent muxes round-robin, one superframe per
    # dispatch.
    cfg = DvbtConfig(mode=TransmissionMode.M8K, bandwidth_mhz=8,
                     constellation=Constellation.QAM64,
                     code_rate=CodeRate.R7_8, guard=GuardInterval.G1_32)
    fn = jax.jit(lambda ts, st: txd.modulate_superframe(cfg, ts, st),
                 donate_argnums=(1,))
    n_streams = 4
    rng = np.random.default_rng(0)
    states = [txd.init_state(cfg) for _ in range(n_streams)]
    _hb("dvbt", f"devices acquired: {jax.devices()}")

    import jax.numpy as jnp

    def make_round(r):
        return [jax.device_put(jnp.asarray(
            _ts_block(rng, cfg.ts_bytes_per_superframe)))
            for _ in range(n_streams)]

    _deadline_segments(
        metrics, "dvbt_8k_qam64_r78_iq_throughput", fn, make_round, states,
        samples_per_round=n_streams * cfg.samples_per_superframe,
        rounds_per_segment=4, floor=DVBT_FLOOR_MSPS, deadline=deadline,
        blocks_per_dispatch=1, streams=n_streams)


def _batched_bench(metrics, name, runner, sharding, n_blocks, block_bytes,
                   samples_per_block, floor, deadline, seed,
                   rounds_per_segment=2):
    import jax
    import jax.numpy as jnp
    # dispatch-size sweep hook (`bench.py --sweep <name>`)
    n_blocks = int(os.environ.get("DTV_BENCH_BLOCKS", n_blocks))
    rng = np.random.default_rng(seed)

    def make_round(r):
        return [jax.device_put(jnp.asarray(
            _ts_block(rng, (n_blocks, block_bytes))), sharding)]

    fn = lambda b, st: (runner(b), st)   # noqa: E731
    _deadline_segments(
        metrics, name, fn, make_round, [None],
        samples_per_round=n_blocks * samples_per_block,
        rounds_per_segment=rounds_per_segment, floor=floor,
        deadline=deadline, blocks_per_dispatch=n_blocks)


def bench_dvbt2(metrics, deadline) -> None:
    import jax
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    from dtv_utils_tpu.parallel import stream as ps
    from dtv_utils_tpu.tx import dvbt2 as txt2
    _hb("dvbt2", "imports done")

    cfg = PROFILES["bbc"]
    mesh = ps.make_mesh(jax.devices()[:1])
    _hb("dvbt2", f"devices acquired: {jax.devices()}")
    run, sharding = ps.sharded_dvbt2_modulator(cfg, mesh)
    _batched_bench(metrics, "dvbt2_32k_bbc_iq_throughput", run, sharding,
                   n_blocks=4, block_bytes=cfg.payload_bytes_per_frame,
                   samples_per_block=txt2.samples_per_frame(cfg),
                   floor=DVBT_FLOOR_MSPS, deadline=deadline, seed=1,
                   rounds_per_segment=1)


def bench_j83b(metrics, deadline) -> None:
    import jax
    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.tx import j83b as txq
    _hb("j83b", "imports done")

    # Serving shape: 4 independent muxes round-robin, one superblock per
    # dispatch (the batched/sharded variant's vmapped carry derivation
    # replays framing + RS + interleave per block and compiles slowly).
    cfg = J83bConfig()
    fn = jax.jit(lambda ts, st: txq.modulate_superblock(cfg, ts, st),
                 donate_argnums=(1,))
    n_streams = 4
    rng = np.random.default_rng(2)
    states = [txq.init_state(cfg) for _ in range(n_streams)]
    _hb("j83b", f"devices acquired: {jax.devices()}")
    blk = txq.PACKETS_PER_SUPERBLOCK * 188

    import jax.numpy as jnp
    def make_round(r):
        return [jax.device_put(jnp.asarray(_ts_block(rng, blk)))
                for _ in range(n_streams)]

    _deadline_segments(
        metrics, "j83b_qam64_iq_throughput", fn, make_round, states,
        samples_per_round=n_streams * 3612420, rounds_per_segment=2,
        floor=J83B_FLOOR_MSPS, deadline=deadline,
        blocks_per_dispatch=1, streams=n_streams)


def bench_papr(metrics, deadline) -> None:
    """FULL two-pass papr tool on device-resident chunks: pass-1 stats AND
    the fused CCDF pass in ONE dispatch per chunk (the nested jits inline).
    Chunks are generated on device (one PRNG key each) and made resident
    before timing."""
    import jax
    import jax.numpy as jnp
    from dtv_utils_tpu.analysis import papr
    _hb("papr", "imports done")

    n_complex = 1 << 26              # 64M complex = 512 MiB per chunk
    gen = jax.jit(lambda k: jax.random.normal(
        k, (2 * n_complex,), dtype=jnp.float32))
    _hb("papr", f"devices acquired: {jax.devices()}")
    # 13 CCDF levels ~ a typical 12 dB PAPR report (papr.c:138-141).
    levels = jnp.asarray(np.power(10.0, np.arange(13) / 10.0)
                         .astype(np.float32))
    full = jax.jit(lambda raw, zero: (papr._pass1_chunk(raw, zero),
                                      papr._pass2_chunk(raw, levels, zero)))
    keys = iter(jax.random.split(jax.random.PRNGKey(0), 64))

    def make_round(r):
        return [gen(next(keys))]

    fn = lambda raw, st: (full(raw, papr.ZERO), st)   # noqa: E731
    _deadline_segments(
        metrics, "papr_scan_throughput", fn, make_round, [None],
        samples_per_round=n_complex, rounds_per_segment=2, floor=1.0,
        deadline=deadline, unit="GSa/s/chip", scale=1e9)


def _run_inproc(name: str, budget: float) -> None:
    _require_gpu()
    from dtv_utils_tpu.utils.metrics import Metrics
    deadline = _T0 + budget
    globals()["bench_" + name](Metrics(suppress_human=True), deadline)
    _hb(name, "bench complete")


def _run_inproc_all(budget: float) -> None:
    """All four metrics in ONE process (phase 1); a bench that fails or
    runs out of time is left for phase 2's isolated retry."""
    _require_gpu()
    from dtv_utils_tpu.utils.metrics import Metrics
    m = Metrics(suppress_human=True)
    deadline = _T0 + budget
    for name in ORDER:
        left = deadline - time.perf_counter()
        if left < 20:
            _hb(name, f"phase-1 budget exhausted ({left:.0f}s left); "
                      "leaving for phase 2")
            break
        per = min(deadline, time.perf_counter() + TIMEOUTS[name])
        try:
            globals()["bench_" + name](m, per)
            _hb(name, "phase-1 bench complete")
        except Exception as e:          # noqa: BLE001 — keep going
            _hb(name, f"phase-1 bench failed: {type(e).__name__}: {e}")


def _pump(pipe, sink, tag: str) -> None:
    for line in iter(pipe.readline, ""):
        if tag and not line.startswith("{"):
            line = tag + line
        sink.write(line)
        sink.flush()
    pipe.close()


METRIC_OF = {"dvbt": "dvbt_8k_qam64_r78_iq_throughput",
             "papr": "papr_scan_throughput",
             "j83b": "j83b_qam64_iq_throughput",
             "dvbt2": "dvbt2_32k_bbc_iq_throughput"}


def _run_child(args: list, budget: float, tag: str) -> set:
    """Spawn a bench child, STREAM its stdout (a kill loses nothing
    already emitted), kill at `budget`; returns the metric names it
    emitted."""
    p = subprocess.Popen(
        [sys.executable, __file__, *args], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO))
    got: set = set()

    class _Tee:
        def write(self, line):
            if line.startswith("{"):
                try:
                    got.add(json.loads(line)["metric"])
                except (ValueError, KeyError):
                    pass
            sys.stdout.write(line)

        def flush(self):
            sys.stdout.flush()

    threads = [
        threading.Thread(target=_pump, args=(p.stdout, _Tee(), ""),
                         daemon=True),
        threading.Thread(target=_pump, args=(p.stderr, sys.stderr, ""),
                         daemon=True)]
    for t in threads:
        t.start()
    try:
        p.wait(timeout=budget)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        print(f"[bench] {tag}: budget {budget}s exhausted (killed; "
              f"lines already emitted stand)", file=sys.stderr, flush=True)
    for t in threads:
        t.join(timeout=10)
    return got


def main(budgets=None) -> int:
    """Two-phase fail-open runner (see module docstring).  When explicit
    per-metric budgets are given (--stress), only the isolated path runs.

    Returns the number of metrics that printed nothing (0 = success)."""
    t0 = time.perf_counter()
    got: set = set()
    if budgets is None:
        budgets = TIMEOUTS
        got |= _run_child(["--inproc-all", str(PHASE1_BUDGET - 10.0)],
                          PHASE1_BUDGET, "phase1")
    for name in ORDER:
        if METRIC_OF[name] in got:
            continue
        budget = budgets[name]
        # Child deadline slightly inside the kill budget so it can stop
        # cleanly and flush.
        got |= _run_child(
            ["--inproc", name, str(max(budget - 5.0, budget * 0.8))],
            budget, name)
        if METRIC_OF[name] not in got:
            print(f"[bench] {name}: NO metric emitted", file=sys.stderr,
                  flush=True)
    missing = sum(METRIC_OF[n] not in got for n in ORDER)
    print(f"[bench] total {time.perf_counter() - t0:.1f}s, "
          f"{missing} metric(s) missing", file=sys.stderr, flush=True)
    return missing


def sweep(name: str, sizes=(1, 2, 4, 8), budget: float = 100.0) -> None:
    """Dispatch-size sweep: run one bench at several blocks-per-dispatch,
    one subprocess per size (a failing compile at one size cannot poison
    the rest)."""
    for L in sizes:
        print(f"[sweep] {name} blocks_per_dispatch={L}", file=sys.stderr,
              flush=True)
        env = dict(os.environ, DTV_BENCH_BLOCKS=str(L))
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--inproc", name, str(budget)],
                text=True, capture_output=True, timeout=budget + 20,
                env=env, cwd=str(REPO))
        except subprocess.TimeoutExpired:
            print(f"[sweep] {name} L={L}: timeout", file=sys.stderr,
                  flush=True)
            continue
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if lines:
            print(lines[-1], flush=True)
        else:
            print(f"[sweep] {name} L={L}: FAILED rc={r.returncode}: "
                  f"{r.stderr.strip().splitlines()[-1] if r.stderr else ''}",
                  file=sys.stderr, flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--inproc-all":
        _run_inproc_all(float(sys.argv[2]) if len(sys.argv) > 2 else 600.0)
    elif len(sys.argv) >= 3 and sys.argv[1] == "--inproc":
        budget = float(sys.argv[3]) if len(sys.argv) > 3 else 120.0
        _run_inproc(sys.argv[2], budget)
    elif len(sys.argv) >= 3 and sys.argv[1] == "--sweep":
        sweep(sys.argv[2])
    elif len(sys.argv) >= 2 and sys.argv[1] == "--stress":
        b = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
        sys.exit(main({name: b for name in ORDER}))
    else:
        sys.exit(1 if main() else 0)
