"""PAPR + CCDF analyzer for float32 interleaved-IQ streams.

Behavioral parity target: /root/reference/papr.c — two passes over the file
(global power stats, then % of samples above each 1 dB / 0.1 dB level), with
byte-identical stdout.  Redesign as device array programs:

  * the O(samples x levels) threshold-compare loop (papr.c:147-151) becomes
    one broadcast-compare + reduce fused with the power computation;
  * per-sample power/peak/rail statistics are associative reductions, so the
    file streams through device memory in chunks of any size and shards
    across devices/hosts trivially;
  * float32 sample math + float64 accumulation reproduce the C float/double
    split bit-for-bit on real inputs.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np


# An int32 zero handed to the device programs as a run-time argument (see
# _power_f32): a value the compiler cannot fold.
ZERO = np.zeros((), np.int32)


def _power_f32(i: jax.Array, q: jax.Array, zero: jax.Array) -> jax.Array:
    """i² + q² with separately-rounded float32 products.

    The reference computes float32 mul, float32 mul, float32 add
    (papr.c:103).  XLA:CPU fuses that into an FMA whose single rounding
    flips last-ulp peak values, and an optimization barrier does not stop
    it (XLA:CPU removes the barrier before fusion).  So each rounded
    product's bits are OR-ed with ``zero``, an int32 0 that is a run-time
    argument of the outermost program: the compiler cannot see through it,
    so the add reads two rounded products on every backend.
    """
    def rounded_square(x):
        bits = jax.lax.bitcast_convert_type(x * x, jnp.int32) | zero
        return jax.lax.bitcast_convert_type(bits, jnp.float32)
    return rounded_square(i) + rounded_square(q)


_STAT_KEYS = ("peak", "real_pos", "real_neg", "imag_pos", "imag_neg")

# Deinterleave layout: [rows, 256] float32, I and Q as the even and odd
# columns of each row (strided slices, no gather).
_LANE = 256


def _pad_to_lanes(raw: np.ndarray) -> np.ndarray:
    """Pad an even-length interleaved buffer to a _LANE multiple by
    repeating the first IQ pair: duplicates can never win a strict-
    improvement max/min (first occurrence keeps the smaller index)."""
    rem = (-len(raw)) % _LANE
    if rem == 0:
        return raw
    pad = np.tile(raw[:2], rem // 2)
    return np.concatenate([raw, pad])


@jax.jit
def _pass1_chunk(raw: jax.Array, zero: jax.Array):
    """Stats of one chunk (raw = interleaved IQ float32, length a multiple
    of _LANE): everything the reference's first pass reports, PACKED into
    two small arrays (vals [5] f32, idxs [5] i32 — order _STAT_KEYS): one
    host transfer per chunk.  Indices are chunk-local complex indices
    (argmax of the row-major [rows, 128] views = flat complex index); the
    streaming combiner rebases them.  ``zero`` is ZERO (see _power_f32)."""
    r = raw.reshape(-1, _LANE)
    i = r[:, 0::2]                    # [rows, 128]: lane-local shuffle
    q = r[:, 1::2]
    power = _power_f32(i, q, zero)
    peak_idx = jnp.argmax(power)      # flat over [rows*128] = complex index
    vals = jnp.stack([power.reshape(-1)[peak_idx], jnp.max(i), jnp.min(i),
                      jnp.max(q), jnp.min(q)])
    idxs = jnp.stack([peak_idx, jnp.argmax(i), jnp.argmin(i),
                      jnp.argmax(q), jnp.argmin(q)]).astype(jnp.int32)
    return vals, idxs


@jax.jit
def _pass2_chunk(raw: jax.Array, levels: jax.Array, zero: jax.Array):
    """Count of samples with power strictly above each level — the exact C
    compare ``power > level[i]`` (papr.c:147-151) as one broadcast-compare
    + reduce that XLA fuses into the power computation (one read of the
    chunk, no materialized [n, L] intermediate).  Zero-padded tails are
    safe: power 0 never exceeds a positive level."""
    r = raw.reshape(-1, _LANE)
    i = r[:, 0::2]
    q = r[:, 1::2]
    power = _power_f32(i, q, zero)                       # [rows, 128]
    cmp = power[:, :, None] > levels[None, None, :]      # [rows, 128, L]
    return jnp.sum(cmp, axis=(0, 1), dtype=jnp.int32)


class PaprStats:
    """Aggregated first-pass statistics (reference semantics).

    Reference nuances preserved: peaks start at 0.0 and update only on a
    STRICT improvement (papr.c:105-126), so the first occurrence wins and
    all-negative rails report 0.0 @ 0.
    """

    def __init__(self):
        self.n = 0
        self.power_sum = 0.0
        self.peak = 0.0
        self.peak_offset = 0
        self.real_pos = 0.0
        self.real_pos_offset = 0
        self.real_neg = 0.0
        self.real_neg_offset = 0
        self.imag_pos = 0.0
        self.imag_pos_offset = 0
        self.imag_neg = 0.0
        self.imag_neg_offset = 0

    def update(self, chunk_stats: tuple, base: int):
        # ONE transfer for the packed (vals, idxs) pair
        vals, idxs = jax.device_get(chunk_stats)
        s = dict(zip(_STAT_KEYS, zip(vals.tolist(), idxs.tolist())))
        if s["peak"][0] > self.peak:
            self.peak = s["peak"][0]
            self.peak_offset = base + int(s["peak"][1])
        for rail, cmp in (("real_pos", 1), ("real_neg", -1),
                          ("imag_pos", 1), ("imag_neg", -1)):
            v, idx = s[rail]
            if cmp * v > cmp * getattr(self, rail):
                setattr(self, rail, v)
                setattr(self, rail + "_offset", base + int(idx))

    @property
    def mean_power(self) -> float:
        # empty file: C divides 0.0 by 0 and gets a (negative-signed) NaN
        # rather than trapping (papr.c) — keep the float64 division
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.float64(self.power_sum)
                         / np.float64(self.n if self.n else 0.0))

    @property
    def papr_db(self) -> float:
        # C: float papr = 10 * log10((double)peak / sum) — double math,
        # then one rounding to float32 on assignment (papr.c:134)
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(np.float32(
                10.0 * np.log10(np.float64(self.peak)
                                / np.float64(self.mean_power))))


_REF_CHUNK_FLOATS = 16384          # papr.c:30 CHUNK_SIZE


def _stale_q(path: str) -> np.float32:
    """Reference semantics for an odd trailing float: papr.c's i+=2 loop
    pairs it with buffer[length], which is the STATIC 16384-float buffer's
    stale content — 0.0 if the file fits in one chunk, else the previous
    chunk's float at the same buffer offset."""
    import os
    total = os.path.getsize(path) // 4
    if total < _REF_CHUNK_FLOATS:
        return np.float32(0.0)
    idx = (total // _REF_CHUNK_FLOATS - 1) * _REF_CHUNK_FLOATS \
        + total % _REF_CHUNK_FLOATS
    with open(path, "rb") as f:
        f.seek(idx * 4)
        return np.frombuffer(f.read(4), dtype=np.float32)[0]


def _iter_chunks(path: str, chunk_complex: int):
    """Yield (raw_interleaved, base_offset) float32 arrays from a cfile."""
    base = 0
    with open(path, "rb") as f:
        while True:
            raw = np.fromfile(f, dtype=np.float32, count=2 * chunk_complex)
            if raw.size == 0:
                break
            if raw.size % 2:  # trailing half-sample: the reference pairs it
                raw = np.concatenate(  # with the stale chunk-buffer float
                    [raw, np.asarray([_stale_q(path)], np.float32)])
            yield raw, base
            base += raw.size // 2
            if raw.size < 2 * chunk_complex:
                break


def analyze_file(path: str, chunk_complex: int = 1 << 22) -> PaprStats:
    stats = PaprStats()
    for raw, base in _iter_chunks(path, chunk_complex):
        stats.update(_pass1_chunk(jnp.asarray(_pad_to_lanes(raw)), ZERO),
                     base)
        # The f64 power accumulation runs on the HOST: numpy's f32 multiply
        # rounds exactly like the C tool's, and f64 accumulation of f32
        # power values is exact at any realistic file size (24-bit addends,
        # 53-bit accumulator) — so chunking cannot change the sum.  (JAX
        # computes no float64 unless x64 is enabled process-wide.)
        sq = raw * raw
        power = sq.reshape(-1, 2).sum(axis=1, dtype=np.float32)  # ii + qq
        stats.power_sum += float(np.sum(power, dtype=np.float64))
        stats.n += raw.size // 2
    return stats


def ccdf_counts(path: str, levels: np.ndarray,
                chunk_complex: int = 1 << 22) -> np.ndarray:
    counts = np.zeros(len(levels), dtype=np.int64)
    lv = jnp.asarray(levels.astype(np.float32))
    for raw, _ in _iter_chunks(path, chunk_complex):
        rem = (-len(raw)) % _LANE
        if rem:
            raw = np.concatenate([raw, np.zeros(rem, np.float32)])
        counts += np.asarray(_pass2_chunk(jnp.asarray(raw), lv, ZERO))
    return counts


def make_levels(mean_power: float, papr_db: float, graph: bool) -> np.ndarray:
    """levels[i] = 10^(step·i/10) · mean, float32 (papr.c:138-141,169-172)."""
    if np.isnan(papr_db):
        # empty file: C's (int)nan is INT_MIN, so the level loops never run
        return np.empty(0, dtype=np.float32)
    if graph:
        # the reference accumulates index += 0.1f in float32 (papr.c:169-173),
        # so the float32 rounding error accumulates — replicate exactly
        n = int(np.float32(papr_db) * np.float32(10)) + 1
        idx = np.empty(n, dtype=np.float32)
        acc = np.float32(0.0)
        for i in range(n):
            idx[i] = acc
            acc = acc + np.float32(0.1)
    else:
        n = int(papr_db) + 1
        idx = np.arange(n, dtype=np.float32)
    return (np.power(10.0, (idx / np.float32(10)).astype(np.float64))
            * mean_power).astype(np.float32)


def _cfmt(x: float) -> str:
    """C printf %f, including the x86 quiet-NaN sign: 0.0/0.0 prints -nan."""
    return "-nan" if np.isnan(x) else f"{x:f}"


def format_report(stats: PaprStats, counts: np.ndarray, graph: bool) -> str:
    """Byte-identical stdout of ``papr [-g] <infile>`` (papr.c:130-190)."""
    out = []
    n = np.float32(stats.n)
    if not graph:
        out.append(f"Peak magnitude = {np.sqrt(stats.peak):f}")
        out.append(f"average power = {_cfmt(stats.mean_power)}, "
                   f"peak power = {stats.peak:f} @ {stats.peak_offset * 8}")
        out.append("")
        out.append(f"Maximum PAPR = {_cfmt(stats.papr_db)}")
        for i, c in enumerate(counts):
            # C: ((float)count/(float)offset) * 100.0 — f32 divide, then
            # promotion to double for the multiply (papr.c:155)
            pct = float(np.float32(c) / n) * 100.0
            out.append(f"percentage above {i} dB = {pct:0.8f}")
        out.append("")
        out.append(f"peak real positive = {stats.real_pos:f}, "
                   f"peak imaginary positive = {stats.imag_pos:f}")
        out.append(f"peak real negative = {stats.real_neg:f}, "
                   f"peak imaginary negative = {stats.imag_neg:f}")
        out.append("")
        out.append(f"peak real positive @ {stats.real_pos_offset * 8}, "
                   f"peak imaginary positive @ {stats.imag_pos_offset * 8 + 1}")
        out.append(f"peak real negative @ {stats.real_neg_offset * 8}, "
                   f"peak imaginary negative @ {stats.imag_neg_offset * 8 + 1}")
        return "\n".join(out) + "\n"
    for c in counts:
        pct = float(np.float32(c) / n) * 100.0
        out.append(f"{pct:0.8f}")
    return "\n".join(out) + "\n" if out else ""   # no levels -> no output


def cli(argv: list[str]) -> int:
    graph = False
    if len(argv) not in (1, 2):
        print("usage: papr -g <infile>\nOptions:\n\tg = graph suitable output",
              file=sys.stderr)
        return 255
    if len(argv) == 2:
        if not argv[0].startswith("-"):
            print("usage: papr -g <infile>", file=sys.stderr)
            return 255
        for ch in argv[0][1:]:
            if ch in "gG":
                graph = True
            else:
                print(f"Unsupported Option: {ch}", file=sys.stderr)
        path = argv[1]
    else:
        path = argv[0]
    try:
        stats = analyze_file(path)
    except FileNotFoundError:
        print(f"Cannot open bitstream file <{path}>", file=sys.stderr)
        return 255
    levels = make_levels(stats.mean_power, stats.papr_db, graph)
    counts = ccdf_counts(path, levels)
    sys.stdout.write(format_report(stats, counts, graph))
    return 0
