#!/usr/bin/env python3
"""Time, on the card, the forms the chains' FFT and J.83B RRC filter were
chosen from, and the device copy rate they are judged against.

    python tools/measure_choices.py [--batch 8] [--reps 10] > choices.jsonl

One JSON line per measurement, each with the card's name and power limit
(nvidia-smi):

  ifft         ops/cfft.fft_ri (jnp.fft; cuFFT on the GPU) against the
               four-step matmul DFT at HIGHEST precision that the chains
               used before it, at the chains' batches: DVB-T 8K x 272
               symbols, T2 32K x one bbc frame, T2 4K x one blade frame.
  rrc          tx/j83b.rrc_interpolate (50 shifted slices per phase)
               against conv_general_dilated at HIGHEST and at default
               precision, at 1,806,210 cells (one superblock).
  copy         a 1 GiB device-to-device copy and a 1 GiB ``x + 1``.
  papr_power   analysis/papr._power_f32 and the optimization_barrier form
               it replaced, each against numpy's float32 i*i + q*q on 64M
               complex samples (mismatched samples; 0 = no FMA).

Each call holds ``--batch`` independent transforms or superblocks, so
device time dominates it; a time is the median of 7 rounds of ``--reps``
calls, each round ended by jax.block_until_ready, divided by the batch.
Errors are against float64 numpy.  bytes/s count one read of the input and
one write of the output.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

HIGHEST = jax.lax.Precision.HIGHEST
RRC_CELLS = 1_806_210


# ---------------------------------------------------------------------------
# the candidates that were not kept
# ---------------------------------------------------------------------------

@functools.cache
def _dft_plan(n: int, sign: int):
    """Four-step plan of an n-point DFT, n = n1 * n2, n2 = min(n, 256):
    (DFT(n2), twiddles [n1, n2], DFT(n1)) as complex128."""
    assert n & (n - 1) == 0 and n >= 2, f"power-of-two size required: {n}"
    n2 = min(n, 256)
    n1 = n // n2
    a, b = np.arange(n2), np.arange(n1)
    s = 2j * np.pi * sign
    return (np.exp(s * np.outer(a, a) / n2), np.exp(s * np.outer(b, a) / n),
            np.exp(s * np.outer(b, b) / n1))


def matmul_dft_ri(xr, xi, sign: int = -1):
    """Unnormalized DFT along the last axis of re/im rails as two complex
    matmuls (four-step: DFT(n2), twiddle, DFT(n1)), HIGHEST precision.
    Same contract as ops/cfft.fft_ri."""
    n = xr.shape[-1]
    w2, tw, w1 = _dft_plan(n, sign)
    f32 = lambda c: (jnp.asarray(c.real, jnp.float32),
                     jnp.asarray(c.imag, jnp.float32))

    def cmm(ar, ai, spec, br, bi):
        ein = functools.partial(jnp.einsum, spec, precision=HIGHEST)
        return ein(ar, br) - ein(ai, bi), ein(ar, bi) + ein(ai, br)

    w2r, w2i = f32(w2)
    n2, n1 = w2.shape[0], w1.shape[0]
    if n1 == 1:
        return cmm(xr, xi, "...k,kp->...p", w2r, w2i)
    lead = xr.shape[:-1]
    gr = jnp.swapaxes(xr.reshape(*lead, n2, n1), -2, -1)    # [..., n1, n2]
    gi = jnp.swapaxes(xi.reshape(*lead, n2, n1), -2, -1)
    sr, si = cmm(gr, gi, "...ba,ad->...bd", w2r, w2i)       # over a
    twr, twi = f32(tw)
    tr, ti = sr * twr - si * twi, sr * twi + si * twr
    w1r, w1i = f32(w1)
    outr, outi = cmm(w1r, w1i, "cb,...bd->...cd", tr, ti)   # over b
    return outr.reshape(*lead, n), outi.reshape(*lead, n)


def rrc_conv(cells, tail, taps: np.ndarray, precision=HIGHEST):
    """tx/j83b.rrc_interpolate's output as two conv_general_dilated calls
    (one per polyphase branch)."""
    n = cells.shape[1]
    x = jnp.concatenate([tail, cells], axis=1)[:, None, :]  # [2, 1, 49+n]
    outs = []
    for p in range(2):
        hp = jnp.asarray(np.ascontiguousarray(taps[p::2][::-1]))
        y = jax.lax.conv_general_dilated(x, hp[None, None, :], (1,),
                                         "VALID", precision=precision)
        outs.append(y[:, 0, :n])
    return jnp.stack(outs, axis=-1).reshape(2, -1)


def barrier_power(raw):
    """The PAPR power form analysis/papr._power_f32 replaced: both products
    behind an optimization_barrier, then added."""
    i, q = raw[0::2], raw[1::2]
    ii, qq = jax.lax.optimization_barrier((i * i, q * q))
    return ii + qq


# ---------------------------------------------------------------------------
# measurements
# ---------------------------------------------------------------------------

def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"


def _time(f, *args, reps: int) -> float:
    """Median seconds per call over 7 rounds of `reps` calls."""
    jax.block_until_ready(f(*args))
    rounds = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = f(*args)
        jax.block_until_ready(r)
        rounds.append((time.perf_counter() - t0) / reps)
    return float(np.median(rounds))


def measure_ifft(batch: int, reps: int, emit) -> None:
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    from dtv_utils_tpu.ops import cfft
    shapes = {"dvbt_8k": (272, 8192),
              "t2_32k_bbc": (PROFILES["bbc"].frame_symbols, 32768),
              "t2_4k_blade": (PROFILES["blade"].frame_symbols, 4096)}
    rng = np.random.default_rng(0)
    for name, (sym, n) in shapes.items():
        xr = rng.standard_normal((batch, sym, n), dtype=np.float32)
        xi = rng.standard_normal((batch, sym, n), dtype=np.float32)
        want = np.fft.ifft(xr[0] + 1j * xi[0].astype(np.float64)) * n
        rms = np.sqrt(np.mean(np.abs(want) ** 2))
        args = (jnp.asarray(xr), jnp.asarray(xi))
        for impl, fft in (("jnp_fft", cfft.fft_ri),
                          ("matmul_dft", matmul_dft_ri)):
            f = jax.jit(lambda a, b, fft=fft: fft(a, b, sign=+1))
            s = _time(f, *args, reps=reps) / batch
            gr, gi = (np.asarray(v[0]) for v in f(*args))
            emit(what="ifft", name=name, shape=[sym, n], impl=impl,
                 seconds=s, rel_err=float(np.abs(gr + 1j * gi - want).max()
                                          / rms))


def measure_rrc(batch: int, reps: int, emit) -> None:
    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.tx import j83b as txq
    from j83b_serial_ref import rrc_polyphase
    taps = txq.rrc_taps(J83bConfig())
    rng = np.random.default_rng(1)
    cells = rng.standard_normal((batch, 2, RRC_CELLS), dtype=np.float32)
    tails = np.zeros((batch, 2, 49), np.float32)
    want = rrc_polyphase(cells[0, 0] + 1j * cells[0, 1], taps)
    nbytes = (2 * (49 + RRC_CELLS) + 2 * 2 * RRC_CELLS) * 4
    args = (jnp.asarray(cells), jnp.asarray(tails))
    for impl, one in (
            ("slices", lambda c, t: txq.rrc_interpolate(c, t, taps)[0]),
            ("conv_highest", lambda c, t: rrc_conv(c, t, taps, HIGHEST)),
            ("conv_default", lambda c, t: rrc_conv(c, t, taps, None))):
        f = jax.jit(jax.vmap(one))
        s = _time(f, *args, reps=reps) / batch
        y = np.asarray(f(*args)[0])
        emit(what="rrc", impl=impl, cells=RRC_CELLS, seconds=s,
             bytes_per_s=nbytes / s,
             max_abs_err=float(np.abs(y[0] + 1j * y[1] - want).max()))


def measure_copy(reps: int, emit) -> None:
    big = jnp.ones((1 << 28,), jnp.float32)                 # 1 GiB
    for impl, f in (("copy", jax.jit(lambda v: v.copy())),
                    ("x_plus_1", jax.jit(lambda v: v + 1.0))):
        s = _time(f, big, reps=reps)
        emit(what="copy", impl=impl, bytes=2 * big.nbytes, seconds=s,
             bytes_per_s=2 * big.nbytes / s)


def measure_papr_power(emit) -> None:
    from dtv_utils_tpu.analysis import papr
    raw = np.random.default_rng(2).standard_normal(2 << 26, dtype=np.float32)
    want = raw[0::2] * raw[0::2] + raw[1::2] * raw[1::2]
    dev = jnp.asarray(raw)
    for impl, f, args in (
            ("opaque_zero", jax.jit(lambda r, z: papr._power_f32(
                r[0::2], r[1::2], z)), (dev, papr.ZERO)),
            ("optimization_barrier", jax.jit(barrier_power), (dev,))):
        got = np.asarray(f(*args))
        emit(what="papr_power", impl=impl, samples=int(want.size),
             mismatched=int(np.count_nonzero(got != want)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8,
                   help="transforms or superblocks per call")
    p.add_argument("--reps", type=int, default=10, help="calls per round")
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"measure_choices: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    card = _card()

    def emit(**rec):
        print(json.dumps({**rec, "card": card}), flush=True)

    measure_ifft(args.batch, args.reps, emit)
    measure_rrc(args.batch, args.reps, emit)
    measure_copy(args.reps, emit)
    measure_papr_power(emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
