"""Receiver CLIs for DVB-T2 and J.83B: IQ cfile in, transport stream out.

Software form of the reference project's over-the-air receiver validation
(/root/reference/README:26-28).  Each command consumes the gr_complex IQ
its matching ``*-mod`` command (or the reference's file sink) writes and
emits the recovered TS plus receiver health metrics.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def dvbt2_rx_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="dtv dvbt2-rx",
        description="Demodulate a DVB-T2 IQ stream back to TS")
    p.add_argument("--profile", default="blade",
                   help="parameter profile: blade (default) or bbc")
    p.add_argument("--papr", action="store_true",
                   help="stream was modulated with tone-reservation PAPR")
    p.add_argument("-o", "--output", dest="outfile", default=None)
    p.add_argument("infile", metavar="input_file",
                   help="gr_complex (float32 interleaved IQ) input file")
    args = p.parse_args(argv)

    import dataclasses
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    cfg = PROFILES[args.profile]
    if args.papr:
        cfg = dataclasses.replace(cfg, papr_tr=True)

    from dtv_utils_tpu.tx.dvbt2 import samples_per_frame
    from dtv_utils_tpu.rx import dvbt2 as rx2
    from dtv_utils_tpu.utils.metrics import Metrics

    iq = np.fromfile(args.infile, dtype=np.complex64)
    spf = samples_per_frame(cfg)
    n = len(iq) // spf
    if n == 0:
        sys.stderr.write(f"input shorter than one T2 frame ({spf})\n")
        return 255
    t0 = time.perf_counter()
    res = rx2.demodulate_stream(cfg, iq[:n * spf])
    dt = time.perf_counter() - t0
    m = Metrics()
    m.emit("dvbt2_rx_throughput", round(n * spf / dt / 1e6, 3),
           unit="Msamples/s", includes_compile=True)
    all_ok = (res.p1_detected and res.sync_crc_ok
              and bool(res.ldpc_ok.all()) and bool(res.bch_ok.all())
              and bool(res.bb_crc_ok.all())
              and res.l1_pre["crc_ok"] and res.l1_post["crc_ok"])
    m.emit("dvbt2_rx_status", int(all_ok), unit="ok",
           ts_bytes=int(res.ts.size), p1=bool(res.p1_detected),
           s1=res.s1, s2=res.s2,
           ldpc_ok=bool(res.ldpc_ok.all()), bch_ok=bool(res.bch_ok.all()),
           l1_pre_crc=res.l1_pre["crc_ok"], l1_post_crc=res.l1_post["crc_ok"],
           sync_crc=res.sync_crc_ok)
    if args.outfile:
        res.ts.tofile(args.outfile)
    return 0


def qam_rx_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="dtv qam-rx",
        description="Demodulate an ITU-T J.83B 64-QAM IQ stream back to TS")
    p.add_argument("-o", "--output", dest="outfile", default=None)
    p.add_argument("infile", metavar="input_file")
    args = p.parse_args(argv)

    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.tx import j83b as txq
    from dtv_utils_tpu.rx import j83b as rxq
    from dtv_utils_tpu.utils.metrics import Metrics

    cfg = J83bConfig()
    iq = np.fromfile(args.infile, dtype=np.complex64)
    blk = 2 * (txq.FRAMES_PER_SUPERBLOCK * txq.FRAME_BITS // 28) * 5
    n = len(iq) // blk
    if n == 0:
        sys.stderr.write(f"input shorter than one superblock ({blk})\n")
        return 255
    t0 = time.perf_counter()
    res = rxq.demodulate_stream(cfg, iq[:n * blk])
    dt = time.perf_counter() - t0
    m = Metrics()
    m.emit("j83b_rx_throughput", round(n * blk / dt / 1e6, 3),
           unit="Msamples/s", includes_compile=True)
    all_ok = (res.fsync_ok and bool(res.rs_ok.all())
              and bool(res.ext_ok.all()) and bool(res.checksum_ok.all()))
    m.emit("j83b_rx_status", int(all_ok), unit="ok",
           ts_bytes=int(res.ts.size), fsync=res.fsync_ok,
           control_word=res.control_word,
           rs_corrected=int(res.rs_errors.sum()),
           rs_uncorrectable=int((~res.rs_ok).sum()))
    if args.outfile:
        res.ts.tofile(args.outfile)
    return 0
