#!/usr/bin/env python3
"""Run the transmit chains and the PAPR scan on a GPU through the ``dtv``
CLI, and check every output against the serial oracles.

    python chip_smoke.py            # every phase below, on one card
    python chip_smoke.py --four     # only the sharded modulators, 4 cards

Phases, in one process, one JSON line each:

  device  the default device must be a GPU (no fallback to another backend)
  dvbt    dvbt-mod 8K 64QAM 7/8 GI 1/32 on 4 superframes: carriers bit-exact
          against tests/dvbt_serial_ref, IQ within max|err|/rms < 1e-3, TS
          recovered by rx/dvbt
  dvbt2   dvbt2-mod --profile bbc -n 2 and --profile blade -n 2: BB frames
          and the first FEC blocks of each frame bit-exact against
          tests/dvbt2_serial_ref, map + cell/time interleave at atol 1e-6,
          IQ against a float64 OFDM of the frame grid, TS recovered by
          rx/dvbt2
  j83b    qam-mod on 2 superblocks: cells bit-exact against
          tests/j83b_serial_ref, IQ within 1e-5 of a float64 polyphase RRC,
          TS recovered by rx/j83b
  papr    papr and papr -g on the 4096-sample cfile of tests/test_papr.py,
          byte-identical to tests/golden; papr on a 64M-complex cfile made
          from --seed, against a numpy reference (float32 i*i + q*q without
          FMA, float64 sum, first-occurrence peaks, CCDF counts)

``--four`` runs parallel/stream's sequence-sharded DVB-T, DVB-T2 (bbc) and
J.83B modulators over a 4-card mesh, one block per card, and compares each
bit for bit with modulate_stream on one card.

Each phase line gives compile and run seconds (compile: the chain's jit
compiled ahead of time; run: the CLI call), the comparisons, and the card's
name and power limit from nvidia-smi.  The last line of stdout is
{"ok": true, "device": {...}} only if every phase passed; otherwise the
exit code is non-zero.  Tolerances and their reasons are in PARITY.md.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

DVBT_ARGV = ["-m", "t8k", "-c", "8", "-C", "qam64", "-r", "7/8",
             "-g", "1/32"]
DVBT_BLOCKS = 4
T2_PROFILES = ("bbc", "blade")
T2_FRAMES = 2
T2_FEC_CHECKED = 2               # FEC blocks per frame run through the oracle
J83B_BLOCKS = 2
PAPR_BIG_COMPLEX = 1 << 26       # 64M complex = 512 MiB of float32 IQ
FOUR_CARDS = 4
TIME_LIMIT_S = 1140.0            # whole run, compilation included
FOUR_LIMIT_S = 600.0             # each chain of --four


def _card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
            f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _line(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _watchdog(phase: str, seconds: float) -> threading.Timer:
    """Report a phase that overruns its wall limit and end the process
    (a compile cannot be interrupted from Python)."""
    def fire():
        _line({"phase": phase, "ok": False,
               "error": f"did not finish within {seconds:.0f} s"})
        os._exit(3)
    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def _ts(rng, n_bytes: int) -> np.ndarray:
    ts = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def _cli(argv: list[str]) -> tuple[float, str]:
    """Run one `dtv` tool in-process; (wall seconds, captured stdout)."""
    from dtv_utils_tpu.cli.main import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"dtv {' '.join(argv)} exited {rc}")
    return dt, buf.getvalue()


def _aot(fn, *args) -> float:
    """Compile a jitted function for these arguments; wall seconds.  Later
    calls with the same shapes reuse the executable."""
    t0 = time.perf_counter()
    fn.lower(*args).compile()
    return time.perf_counter() - t0


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max|got − want| / rms(want)."""
    want = np.asarray(want, np.complex128)
    err = np.abs(np.asarray(got, np.complex128) - want).max()
    return float(err / np.sqrt(np.mean(np.abs(want) ** 2)))


def _check(checks: dict, name: str, ok: bool, value=None) -> None:
    checks[name] = {"ok": bool(ok)} if value is None else \
        {"ok": bool(ok), "value": value}


def _dvbt_cfg():
    """The DvbtConfig the dvbt-mod CLI builds from DVBT_ARGV."""
    from dtv_utils_tpu.models import dvbt as model
    return model.config_from_args(
        model.build_parser().parse_args(DVBT_ARGV + ["unused"]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_dvbt(tmp: Path, rng) -> dict:
    import jax
    import jax.numpy as jnp

    from dtv_utils_tpu.core import cplx
    from dtv_utils_tpu.rx import dvbt as rx
    from dtv_utils_tpu.tx import dvbt as txd
    from dvbt_serial_ref import SerialDvbt

    cfg = _dvbt_cfg()
    blk = cfg.ts_bytes_per_superframe
    ts = _ts(rng, DVBT_BLOCKS * blk)
    (tmp / "in.ts").write_bytes(ts.tobytes())
    compile_s = _aot(txd.jit_modulator(cfg), jnp.asarray(ts[:blk]),
                     txd.init_state(cfg))
    run_s, _ = _cli(["dvbt-mod", *DVBT_ARGV, "-n", str(DVBT_BLOCKS),
                     "-o", str(tmp / "out.cfile"), str(tmp / "in.ts")])
    iq = np.fromfile(tmp / "out.cfile", dtype=np.complex64)

    t0 = time.perf_counter()
    checks: dict = {}
    _check(checks, "iq_shape",
           iq.shape == (DVBT_BLOCKS * cfg.samples_per_superframe,)
           and bool(np.isfinite(iq.view(np.float32)).all()))
    oracle = SerialDvbt(cfg)
    want = oracle.encode_to_carriers(ts[:blk])
    enc = jax.jit(txd.encode_to_carriers, static_argnums=0)
    got, _ = enc(cfg, jnp.asarray(ts[:blk]), txd.init_state(cfg))
    got = cplx.to_np(np.asarray(got))
    _check(checks, "carriers_mismatched",
           np.array_equal(got, want), int(np.sum(got != want)))
    rel = _rel_err(iq[:cfg.samples_per_superframe], oracle.to_iq(want))
    _check(checks, "iq_rel_err", rel < 1e-3, rel)
    res = rx.demodulate_stream(cfg, iq)
    n = len(res.ts)
    _check(checks, "rx_ts_bytes",
           n > 0 and np.array_equal(res.ts, ts[:n]) and res.rs_ok.all()
           and int(res.rs_errors.sum()) == 0, n)
    return dict(compile_s=compile_s, run_s=run_s,
                check_s=time.perf_counter() - t0, checks=checks)


def _t2_iq_reference(cfg, grid: np.ndarray) -> np.ndarray:
    """One T2 frame from its carrier grid rails [2, L_F, K], in float64:
    centred IFFT (unnormalized), cyclic prefix, P1 prepended."""
    from dtv_utils_tpu.tx import dvbt2 as t2
    fft, gi, K = cfg.fft_size, cfg.guard_samples, cfg.carriers
    lf = grid.shape[1]
    left = (fft - K + 1) // 2
    spec = np.zeros((lf, fft), np.complex128)
    spec[:, left:left + K] = grid[0] + 1j * grid[1]
    time_ = np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1) * fft
    sym = np.concatenate([time_[:, fft - gi:], time_], axis=1)
    body = sym.reshape(-1) * (t2.OUTPUT_SCALE / np.sqrt(fft))
    p1 = t2._p1_samples(cfg)
    return np.concatenate([(p1[:, 0] + 1j * p1[:, 1]) * t2.OUTPUT_SCALE,
                           body])


def _phase_dvbt2_profile(tmp: Path, rng, profile: str) -> dict:
    import jax
    import jax.numpy as jnp

    from dtv_utils_tpu.core import cplx
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    from dtv_utils_tpu.rx import dvbt2 as rx
    from dtv_utils_tpu.tx import dvbt2 as t2
    from dvbt2_serial_ref import SerialDvbt2

    cfg = PROFILES[profile]
    blk = cfg.payload_bytes_per_frame
    ts = _ts(rng, T2_FRAMES * blk)
    (tmp / "in.ts").write_bytes(ts.tobytes())
    compile_s = _aot(t2.jit_modulator(cfg), jnp.asarray(ts[:blk]),
                     t2.init_state(cfg))
    run_s, _ = _cli(["dvbt2-mod", "--profile", profile, "-n",
                     str(T2_FRAMES), str(tmp / "in.ts"),
                     str(tmp / "out.cfile")])
    iq = np.fromfile(tmp / "out.cfile", dtype=np.complex64)
    spf = t2.samples_per_frame(cfg)

    t0 = time.perf_counter()
    checks: dict = {}
    _check(checks, "iq_shape", iq.shape == (T2_FRAMES * spf,)
           and bool(np.isfinite(iq.view(np.float32)).all()))
    P = functools.partial
    mode_adapt = jax.jit(P(t2.mode_adapt, cfg))
    fec_encode = jax.jit(P(t2.fec_encode, cfg))
    imap = jax.jit(P(t2.interleave_and_map, cfg))
    cti = jax.jit(P(t2.cell_time_interleave, cfg))
    grid_of = jax.jit(P(t2.build_frame_grid, cfg))
    oracle = SerialDvbt2(cfg)
    state = t2.init_state(cfg)
    bb_bad = fec_bad = 0
    map_err = cti_err = iq_rel = 0.0
    for f in range(T2_FRAMES):
        chunk = ts[f * blk:(f + 1) * blk]
        want_bb = oracle.mode_adapt(chunk)
        bb, state = mode_adapt(jnp.asarray(chunk), state)
        bb_bad += int(np.sum(np.asarray(bb) != want_bb))
        fec = np.asarray(fec_encode(bb))
        k = T2_FEC_CHECKED
        want_fec = oracle.ldpc(oracle.bch(oracle.scramble(want_bb[:k])))
        fec_bad += int(np.sum(fec[:k] != want_fec))
        cells = imap(jnp.asarray(fec))
        want_cells = oracle.map_cells(oracle.bit_interleave(fec))
        map_err = max(map_err, float(np.abs(
            cplx.rails_to_np(np.asarray(cells)) - want_cells).max()))
        payload = cti(cells)
        want_ti = oracle.cell_time_interleave(want_cells)
        cti_err = max(cti_err, float(np.abs(
            cplx.rails_to_np(np.asarray(payload)) - want_ti).max()))
        ref = _t2_iq_reference(cfg, np.asarray(grid_of(payload)))
        iq_rel = max(iq_rel, _rel_err(iq[f * spf:(f + 1) * spf], ref))
    _check(checks, "bbframe_bits_mismatched", bb_bad == 0, bb_bad)
    _check(checks, f"fec_bits_mismatched_first_{T2_FEC_CHECKED}_blocks",
           fec_bad == 0, fec_bad)
    _check(checks, "map_max_abs_err", map_err <= 1e-6, map_err)
    _check(checks, "cell_time_interleave_max_abs_err", cti_err <= 1e-6,
           cti_err)
    _check(checks, "iq_rel_err", iq_rel < 1e-3, iq_rel)
    res = rx.demodulate_stream(cfg, iq)
    n = len(res.ts)
    _check(checks, "rx_ts_bytes",
           n > 0 and np.array_equal(res.ts, ts[:n]) and res.ldpc_ok.all()
           and res.bch_ok.all() and res.bb_crc_ok.all() and res.sync_crc_ok,
           n)
    checks["rx_p1_detected"] = bool(res.p1_detected)     # information only
    return dict(compile_s=compile_s, run_s=run_s,
                check_s=time.perf_counter() - t0, checks=checks)


def phase_dvbt2(tmp: Path, rng) -> dict:
    out = {p: _phase_dvbt2_profile(tmp, rng, p) for p in T2_PROFILES}
    return dict(profiles={p: {k: v for k, v in o.items() if k != "checks"}
                          for p, o in out.items()},
                checks={f"{p}.{k}": v for p, o in out.items()
                        for k, v in o["checks"].items()})


def phase_j83b(tmp: Path, rng) -> dict:
    import jax
    import jax.numpy as jnp

    from dtv_utils_tpu.core import cplx
    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.rx import j83b as rx
    from dtv_utils_tpu.tx import j83b as txq
    from j83b_serial_ref import SerialJ83b, rrc_polyphase

    cfg = J83bConfig()
    blk = txq.PACKETS_PER_SUPERBLOCK * 188
    ts = _ts(rng, J83B_BLOCKS * blk)
    (tmp / "in.ts").write_bytes(ts.tobytes())
    compile_s = _aot(txq.jit_modulator(cfg), jnp.asarray(ts[:blk]),
                     txq.init_state(cfg))
    run_s, _ = _cli(["qam-mod", str(tmp / "in.ts"), str(tmp / "out.cfile")])
    iq = np.fromfile(tmp / "out.cfile", dtype=np.complex64)

    t0 = time.perf_counter()
    checks: dict = {}
    _check(checks, "iq_shape", iq.shape == (J83B_BLOCKS * 2 * 1_806_210,)
           and bool(np.isfinite(iq.view(np.float32)).all()))
    oracle = SerialJ83b()
    enc = jax.jit(functools.partial(txq.encode_to_cells, cfg))
    state = txq.init_state(cfg)
    want, bad = [], 0
    for b in range(J83B_BLOCKS):
        chunk = ts[b * blk:(b + 1) * blk]
        w = oracle.modulate_symbols(chunk)
        got, state = enc(jnp.asarray(chunk), state)
        bad += int(np.sum(cplx.rails_to_np(np.asarray(got)) != w))
        want.append(w)
    _check(checks, "cells_mismatched", bad == 0, bad)
    err = float(np.abs(iq - rrc_polyphase(np.concatenate(want),
                                          txq.rrc_taps(cfg))).max())
    _check(checks, "iq_max_abs_err", err <= 1e-5, err)
    res = rx.demodulate_stream(cfg, iq)
    n = len(res.ts)
    _check(checks, "rx_ts_bytes",
           n > 0 and np.array_equal(res.ts, ts[:n]) and res.fsync_ok
           and res.rs_ok.all() and res.ext_ok.all()
           and res.checksum_ok.all(), n)
    return dict(compile_s=compile_s, run_s=run_s,
                check_s=time.perf_counter() - t0, checks=checks)


def papr_reference(raw: np.ndarray):
    """papr.c's statistics of interleaved float32 IQ in plain numpy:
    (PaprStats, CCDF counts at the 1 dB levels)."""
    from dtv_utils_tpu.analysis import papr
    i, q = raw[0::2], raw[1::2]
    ii = i * i                                  # two rounded products and
    qq = q * q                                  # a rounded sum: no FMA
    power = ii + qq
    s = papr.PaprStats()
    s.n = len(power)
    s.power_sum = float(np.sum(power, dtype=np.float64))
    k = int(np.argmax(power))                   # first occurrence
    s.peak, s.peak_offset = float(power[k]), k
    for rail, x, pick in (("real_pos", i, np.argmax),
                          ("real_neg", i, np.argmin),
                          ("imag_pos", q, np.argmax),
                          ("imag_neg", q, np.argmin)):
        j = int(pick(x))
        sign = 1 if rail.endswith("pos") else -1
        if sign * x[j] > 0:                     # C starts peaks at 0.0
            setattr(s, rail, float(x[j]))
            setattr(s, rail + "_offset", j)
    levels = papr.make_levels(s.mean_power, s.papr_db, False)
    counts = np.asarray([np.count_nonzero(power > lv) for lv in levels],
                        np.int64)
    return s, levels, counts


def phase_papr(tmp: Path, seed: int) -> dict:
    import jax

    from dtv_utils_tpu.analysis import papr

    checks: dict = {}
    small = tmp / "small.cfile"
    (np.random.default_rng(1234).standard_normal(8192) * 0.25).astype(
        np.float32).tofile(small)
    golden = REPO / "tests" / "golden"
    for flag, gold in (([], "papr_4096.txt"), (["-g"], "papr_g_4096.txt")):
        _, out = _cli(["papr", *flag, str(small)])
        _check(checks, gold, out == (golden / gold).read_text())

    raw = np.random.default_rng(seed).standard_normal(
        2 * PAPR_BIG_COMPLEX, dtype=np.float32)
    big = tmp / "big.cfile"
    raw.tofile(big)
    t0 = time.perf_counter()
    ref, levels, counts = papr_reference(raw)
    ref_s = time.perf_counter() - t0
    chunk = min(PAPR_BIG_COMPLEX, 1 << 22)      # analyze_file's default
    spec = jax.ShapeDtypeStruct((2 * chunk,), np.float32)
    compile_s = (_aot(papr._pass1_chunk, spec, papr.ZERO)
                 + _aot(papr._pass2_chunk, spec,
                        jax.ShapeDtypeStruct(levels.shape, np.float32),
                        papr.ZERO))
    run_s, out = _cli(["papr", str(big)])
    got = papr.analyze_file(str(big))
    fields = ("n", "peak", "peak_offset", "real_pos", "real_pos_offset",
              "real_neg", "real_neg_offset", "imag_pos", "imag_pos_offset",
              "imag_neg", "imag_neg_offset")
    bad = [f for f in fields if getattr(got, f) != getattr(ref, f)]
    _check(checks, "big_peaks_and_offsets", not bad, bad)
    got_counts = papr.ccdf_counts(str(big), levels)
    _check(checks, "big_ccdf_counts", np.array_equal(got_counts, counts),
           counts.tolist())
    _check(checks, "big_stdout",
           out == papr.format_report(ref, counts, False))
    return dict(compile_s=compile_s, run_s=run_s, reference_s=ref_s,
                complex_samples=PAPR_BIG_COMPLEX,
                peak=ref.peak, peak_offset=ref.peak_offset, checks=checks)


def _sharded_vs_serial(cfg, mesh, sharded, tx, blk: int, rng) -> dict:
    import jax
    import jax.numpy as jnp

    from dtv_utils_tpu.core import cplx

    n = mesh.devices.size
    ts = _ts(rng, n * blk)
    run, sharding = sharded(cfg, mesh)
    x = jax.device_put(jnp.asarray(ts.reshape(n, blk)), sharding)
    t0 = time.perf_counter()
    compiled = run.lower(x).compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(x))
    run_s = time.perf_counter() - t0
    got = cplx.rails_to_np(np.asarray(out), axis=1)        # [n, samples]
    want, _ = tx.modulate_stream(cfg, ts)
    want = want.reshape(n, -1)
    diff = got != want
    checks: dict = {}
    _check(checks, "samples_mismatched", not diff.any(), int(diff.sum()))
    if diff.any():
        checks["blocks_differing"] = np.nonzero(diff.any(axis=1))[0].tolist()
        checks["max_abs_err"] = float(np.abs(got - want).max())
    return dict(compile_s=compile_s, run_s=run_s, checks=checks)


def phase_four(rng) -> dict:
    import jax

    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    from dtv_utils_tpu.parallel import stream as ps
    from dtv_utils_tpu.tx import dvbt as txd
    from dtv_utils_tpu.tx import dvbt2 as t2
    from dtv_utils_tpu.tx import j83b as txq

    devs = jax.devices()
    if len(devs) < FOUR_CARDS:
        raise RuntimeError(f"--four needs {FOUR_CARDS} devices, "
                           f"found {len(devs)}")
    mesh = ps.make_mesh(devs[:FOUR_CARDS])
    dvbt_cfg = _dvbt_cfg()
    t2_cfg = PROFILES[T2_PROFILES[0]]
    chains = (
        ("dvbt", dvbt_cfg, ps.sharded_dvbt_modulator, txd,
         dvbt_cfg.ts_bytes_per_superframe),
        (f"dvbt2_{T2_PROFILES[0]}", t2_cfg, ps.sharded_dvbt2_modulator, t2,
         t2_cfg.payload_bytes_per_frame),
        ("j83b", J83bConfig(), ps.sharded_j83b_modulator, txq,
         txq.PACKETS_PER_SUPERBLOCK * 188),
    )
    out, checks = {}, {}
    for name, cfg, sharded, tx, blk in chains:
        dog = _watchdog(f"four.{name}", FOUR_LIMIT_S)
        try:
            out[name] = _sharded_vs_serial(cfg, mesh, sharded, tx, blk,
                                           rng)
        finally:
            dog.cancel()
        _line({"phase": f"four.{name}", **out[name]})
        checks.update({f"{name}.{k}": v
                       for k, v in out[name]["checks"].items()})
    return dict(compile_s=sum(o["compile_s"] for o in out.values()),
                run_s=sum(o["run_s"] for o in out.values()),
                checks=checks)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _run_phase(name: str, fn, card: str) -> bool:
    t0 = time.perf_counter()
    try:
        rec = fn()
        ok = all(c["ok"] for c in rec.get("checks", {}).values()
                 if isinstance(c, dict))
    except Exception as e:          # noqa: BLE001 — report, go on
        traceback.print_exc()
        rec = {"error": f"{type(e).__name__}: {e}"}
        ok = False
    _line({"phase": name, "ok": ok, **rec,
           "wall_s": time.perf_counter() - t0, "card": card})
    return ok


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded modulators over 4 cards")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random TS and IQ inputs")
    args = p.parse_args(argv)

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found platform {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import dtv_utils_tpu  # noqa: F401  (compile-cache rule)

    card = _card()
    dog = _watchdog("all", TIME_LIMIT_S)
    n_dev = len(jax.devices())
    _line({"phase": "device", "ok": True, "platform": dev.platform,
           "device_kind": dev.device_kind, "count": n_dev,
           "jax": jax.__version__, "card": card})
    rng = np.random.default_rng(args.seed)
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        tmp = Path(d)
        if args.four:
            ok &= _run_phase("four", lambda: phase_four(rng), card)
        else:
            ok &= _run_phase("dvbt", lambda: phase_dvbt(tmp, rng), card)
            ok &= _run_phase("dvbt2", lambda: phase_dvbt2(tmp, rng), card)
            ok &= _run_phase("j83b", lambda: phase_j83b(tmp, rng), card)
            ok &= _run_phase("papr", lambda: phase_papr(tmp, args.seed),
                             card)
    dog.cancel()
    print(f"card: {card}", flush=True)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
