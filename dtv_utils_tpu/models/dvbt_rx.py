"""DVB-T receiver model: IQ cfile in, transport stream out.

The reference project has no software receiver — it validates transmitters
over the air with consumer hardware (/root/reference/README:26-28).  This
CLI is that validation loop in software: it consumes the gr_complex IQ that
``dtv dvbt-mod -o`` (or the reference's file sink, dvbt-blade.py:213-215)
writes, and emits the recovered TS plus receiver health metrics (RS
corrections, TPS BCH status, pilot-phase lock).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from dtv_utils_tpu.models.dvbt import _CONS, _GUARDS, _MODES, _RATES
from dtv_utils_tpu.core.config import DvbtConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtv dvbt-rx",
        description="Demodulate a DVB-T IQ stream back to TS")
    p.add_argument("-m", "--mode", default="t8k",
                   help="# of carriers. Options: t2k, t8k (default).")
    p.add_argument("-c", "--channel", default=8, type=int, metavar="CH",
                   help="channel width in MHz. Options: 5, 6, 7, 8 (default).")
    p.add_argument("-C", "--cons", default="qam64", metavar="TYPE",
                   help="constellation. qpsk, qam16, qam64 (default).")
    p.add_argument("-r", "--rate", default="7/8",
                   help="Viterbi rate. 1/2, 2/3, 3/4, 5/6, 7/8 (default).")
    p.add_argument("-g", "--guard", dest="interval", default="1/32",
                   metavar="D",
                   help="guard interval. 1/32 (default), 1/16, 1/8, 1/4.")
    p.add_argument("-o", "--output", dest="outfile", default=None,
                   metavar="OUT", help="write the recovered TS to a file.")
    p.add_argument("infile", metavar="input-file",
                   help="gr_complex (float32 interleaved IQ) input file")
    return p


def cli(argv: list[str]) -> int:
    args = build_parser().parse_args(argv)

    def pick(table, key, what):
        try:
            return table[key.lower()]
        except KeyError:
            sys.stderr.write(f"Invalid {what} provided.\n")
            raise SystemExit(255)
    if args.channel not in (5, 6, 7, 8):
        sys.stderr.write("Invalid channel provided.\n")
        raise SystemExit(255)
    cfg = DvbtConfig(mode=pick(_MODES, args.mode, "mode"),
                     bandwidth_mhz=args.channel,
                     constellation=pick(_CONS, args.cons, "constellation"),
                     code_rate=pick(_RATES, args.rate, "Viterbi rate"),
                     guard=pick(_GUARDS, args.interval, "guard interval"))

    iq = np.fromfile(args.infile, dtype=np.complex64)
    spf = cfg.symbols_per_superframe * (cfg.fft_size + cfg.guard_samples)
    n_sf = len(iq) // spf
    if n_sf == 0:
        sys.stderr.write(f"input shorter than one superframe "
                         f"({spf} samples)\n")
        return 255
    iq = iq[:n_sf * spf]

    from dtv_utils_tpu.rx import dvbt as rxd
    from dtv_utils_tpu.utils.metrics import Metrics
    import time
    t0 = time.perf_counter()
    res = rxd.demodulate_stream(cfg, iq)
    dt = time.perf_counter() - t0
    m = Metrics()
    m.emit("dvbt_rx_throughput", round(len(iq) / dt / 1e6, 3),
           unit="Msamples/s", includes_compile=True)
    m.emit("dvbt_rx_status",
           int(res.rs_ok.all() and res.phase_ok and res.tps["all_bch_ok"]),
           unit="ok", ts_bytes=int(res.ts.size),
           rs_packets=int(res.rs_ok.size),
           rs_uncorrectable=int((~res.rs_ok).sum()),
           rs_corrected_bytes=int(res.rs_errors.sum()),
           phase_lock=bool(res.phase_ok),
           tps_bch_ok=bool(res.tps["all_bch_ok"]))
    if args.outfile:
        res.ts.tofile(args.outfile)
    return 0
