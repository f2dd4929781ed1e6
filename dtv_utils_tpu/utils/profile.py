"""Per-stage device profiling + roofline accounting.

Implements SURVEY §5 row 1 (the reference's only profiling is ad-hoc
``\\r`` rate prints, xport.c:2946-2974): every chain stage is compiled
standalone, XLA's ``cost_analysis()`` reports its flops / bytes accessed,
wall time is measured with ``jax.block_until_ready``, and the stage is
scored against the device's published peaks — attainable time =
max(flops/peak_flops, bytes/peak_bw), %-of-roofline = attainable/measured.

``dtv profile {dvbt,dvbt2,j83b}`` prints the stage table (human) and, with
``-j``, JSON lines through utils.metrics so the output stays pipeable.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Peaks:
    """Published dense peak rates of one device."""
    fp32_flops: float            # FLOP/s, float32 outside the tensor cores
    int8_ops: float              # OP/s, int8 tensor cores
    hbm_bytes: float             # device-memory bytes/s
    source: str


# Keyed by the exact jax ``device_kind``.  The DSP stages run float32
# elementwise work, int8 GF(2) matmuls and memory-bound gathers, so these
# are the three rates that bound them.  A GPU missing from this table is an
# error (see _peaks), never a silent default.
CHIP_PEAKS: dict[str, Peaks] = {
    "NVIDIA H100 80GB HBM3": Peaks(
        67e12, 1979e12, 3.35e12,
        "NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense"),
    "NVIDIA H100 PCIe": Peaks(
        51e12, 1513e12, 2.0e12,
        "NVIDIA H100 Tensor Core GPU datasheet, PCIe column, dense"),
}


@dataclass
class StageReport:
    name: str
    ms: float                    # measured device ms per invocation
    flops: float                 # XLA cost_analysis
    bytes_io: float              # argument + result buffer bytes (see below)
    bytes_xla: float             # XLA cost_analysis "bytes accessed"
    roofline_pct: float | None   # attainable/measured (None on the CPU)
    bound: str                   # "memory" | "compute" | "?"
    temp_bytes: float = 0.0      # XLA memory_analysis temp allocation
    int8_flops: float = 0.0      # of which 8-bit integer dots (jaxpr count)

    @property
    def ai(self) -> float:
        """Arithmetic intensity, flops per HBM I/O byte."""
        return self.flops / self.bytes_io if self.bytes_io else 0.0


def _peaks() -> Peaks | None:
    """Peaks of the default device: None on the CPU (no roofline there);
    a ValueError for an accelerator missing from CHIP_PEAKS."""
    import jax
    d = jax.devices()[0]
    if d.platform == "cpu":
        return None
    try:
        return CHIP_PEAKS[d.device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device_kind "
                         f"{d.device_kind!r}; add it to CHIP_PEAKS") from None


def _tree_nbytes(tree) -> float:
    """Total buffer bytes of a pytree of arrays/ShapeDtypeStructs."""
    import jax

    total = 0
    for leaf in jax.tree_util.tree_leaves(tree):
        size = getattr(leaf, "size", None)
        dtype = getattr(leaf, "dtype", None)
        if size is None or dtype is None:
            arr = np.asarray(leaf)
            size, dtype = arr.size, arr.dtype
        total += int(size) * np.dtype(dtype).itemsize
    return float(total)


def _sub_jaxprs(v):
    """The jaxprs held by one equation parameter (a jaxpr, a closed jaxpr,
    or a tuple of them)."""
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(getattr(v, "jaxpr", None), "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_jaxprs(x)


def _int8_dot_flops(jaxpr) -> float:
    """FLOPs (2 per multiply-add) of the dot_generals whose operands are
    both 8-bit integers, read off the jaxpr: XLA's cost analysis gives one
    total for every op type.  A scan body counts ``length`` times, a cond
    its largest branch, a while body once."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            lhs, rhs = (v.aval for v in eqn.invars)
            if all(np.issubdtype(a.dtype, np.integer)
                   and np.dtype(a.dtype).itemsize == 1 for a in (lhs, rhs)):
                (_, rc), (_, rb) = eqn.params["dimension_numbers"]
                free = [d for i, d in enumerate(rhs.shape)
                        if i not in rc and i not in rb]
                total += 2.0 * float(np.prod(lhs.shape)) * float(np.prod(free))
        subs = [_int8_dot_flops(j) for v in eqn.params.values()
                for j in _sub_jaxprs(v)]
        if not subs:
            continue
        if eqn.primitive.name == "scan":
            total += eqn.params["length"] * sum(subs)
        elif eqn.primitive.name == "cond":
            total += max(subs)
        else:
            total += sum(subs)
    return total


# Streaming hook: when set, every StageReport is passed to this callback
# the moment it is measured, so a run killed mid-chain keeps every stage
# already measured.
ON_REPORT = None


def profile_fn(name: str, fn, args, iters: int = 5) -> StageReport:
    """Compile ``fn(*args)``, read its cost analysis, and time ``iters``
    calls of the compiled stage, ended by ``jax.block_until_ready``.

    Roofline bytes model: XLA's ``bytes accessed`` counts LOGICAL traffic —
    every gather/broadcast operand at full size, per use — which for
    gather-heavy interleaver stages exceeds physical memory traffic several
    times over.  The score therefore uses ``bytes_io`` = argument + result
    buffer bytes, a true LOWER bound on device-memory traffic for any fused
    program (inputs read at most once, outputs written exactly once), so
    attainable <= actual <= measured and roofline_pct <= 100 up to
    measurement noise.  The logical figure is kept as ``bytes_xla`` for
    fusion diagnostics.

    Compute model: the 8-bit integer dots (GF(2) matmuls of the RS, BCH,
    LDPC and convolutional encoders) are scored against the int8 rate and
    the rest of XLA's flops against the float32 rate.  A scan body's dots
    count once per iteration, so the int8 share can exceed what XLA counts
    (it counts loop bodies once); the float32 remainder is then clamped at
    0.  Both errors shorten the attainable time, so the score stays at or
    below 100%."""
    import sys

    import jax

    print(f"[profile] {name}: tracing/compiling", file=sys.stderr,
          flush=True)
    traced = jax.jit(fn).trace(*args)
    int8_flops = _int8_dot_flops(traced.jaxpr.jaxpr)
    compiled = traced.lower().compile()
    print(f"[profile] {name}: compiled, timing", file=sys.stderr,
          flush=True)
    flops = bytes_xla = 0.0
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        flops = float(ca.get("flops", 0.0))
        bytes_xla = float(ca.get("bytes accessed", 0.0))
    except Exception:
        pass
    temp_bytes = 0.0
    try:
        ma = compiled.memory_analysis()
        temp_bytes = float(getattr(ma, "temp_size_in_bytes", 0.0))
    except Exception:
        pass
    bytes_io = _tree_nbytes(args) + _tree_nbytes(jax.eval_shape(fn, *args))
    jax.block_until_ready(compiled(*args))           # warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / iters * 1e3

    peaks = _peaks()
    pct, bound = None, "?"
    if peaks is not None:
        t_flop = (int8_flops / peaks.int8_ops
                  + max(flops - int8_flops, 0.0) / peaks.fp32_flops)
        t_mem = bytes_io / peaks.hbm_bytes
        attainable = max(t_flop, t_mem)
        pct = 100.0 * attainable / (ms / 1e3) if ms > 0 else 0.0
        bound = "compute" if t_flop > t_mem else "memory"
    rep = StageReport(name=name, ms=ms, flops=flops, bytes_io=bytes_io,
                      bytes_xla=bytes_xla, roofline_pct=pct, bound=bound,
                      temp_bytes=temp_bytes, int8_flops=int8_flops)
    if ON_REPORT is not None:
        ON_REPORT(rep)
    return rep


def _ts_for(n_bytes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    ts[::188] = 0x47
    return ts


def dvbt2_stages(cfg=None):
    """Stage-by-stage profile of the DVB-T2 chain (one T2 frame)."""
    import jax.numpy as jnp

    from dtv_utils_tpu.core.config import Dvbt2Config
    from dtv_utils_tpu.tx import dvbt2 as t2

    cfg = cfg or Dvbt2Config()
    ts = jnp.asarray(_ts_for(cfg.payload_bytes_per_frame))
    st = t2.init_state(cfg)
    bb, _ = t2.mode_adapt(cfg, ts, st)
    fec = t2.fec_encode(cfg, bb)
    cells = t2.interleave_and_map(cfg, fec)
    payload = t2.cell_time_interleave(cfg, cells)
    grid = t2.build_frame_grid(cfg, payload)

    P = functools.partial
    return [
        profile_fn("mode_adapt", P(t2.mode_adapt, cfg), (ts, st)),
        profile_fn("fec_encode", P(t2.fec_encode, cfg), (bb,)),
        profile_fn("interleave_and_map", P(t2.interleave_and_map, cfg),
                   (fec,)),
        profile_fn("cell_time_interleave", P(t2.cell_time_interleave, cfg),
                   (cells,)),
        profile_fn("build_frame_grid", P(t2.build_frame_grid, cfg),
                   (payload,)),
        profile_fn("grid_to_iq (ifft+cp+p1)", P(t2.grid_to_iq, cfg),
                   (grid,)),
        profile_fn("FULL frame", P(t2.modulate_frame, cfg), (ts, st)),
    ]


def dvbt_stages(cfg=None):
    """Stage profile of the DVB-T chain (one superframe)."""
    import jax.numpy as jnp

    from dtv_utils_tpu.core.config import DvbtConfig
    from dtv_utils_tpu.tx import dvbt as txd

    cfg = cfg or DvbtConfig()
    ts = jnp.asarray(_ts_for(cfg.ts_bytes_per_superframe))
    st = txd.init_state(cfg)
    carriers, _ = txd.encode_to_carriers(cfg, ts, st)

    P = functools.partial
    return [
        profile_fn("encode_to_carriers", P(txd.encode_to_carriers, cfg),
                   (ts, st)),
        profile_fn("carriers_to_iq (ifft+cp)", P(txd.carriers_to_iq, cfg),
                   (carriers,)),
        profile_fn("FULL superframe", P(txd.modulate_superframe, cfg),
                   (ts, st)),
    ]


def j83b_stages(cfg=None):
    """Stage profile of the J.83B chain (one superblock), including the
    sub-stages of encode_to_cells."""
    import jax.numpy as jnp

    from dtv_utils_tpu.core import bits as bitops
    from dtv_utils_tpu.core.config import J83bConfig
    from dtv_utils_tpu.tx import j83b as txq

    cfg = cfg or J83bConfig()
    ts = jnp.asarray(_ts_for(txq.PACKETS_PER_SUPERBLOCK * 188))
    st = txq.init_state(cfg)
    cells, _ = txq.encode_to_cells(cfg, ts, st)
    taps = txq.rrc_taps(cfg)            # concrete, closed over (static FIR)

    # sub-stage inputs (concrete, staged once)
    n_pkt = txq.PACKETS_PER_SUPERBLOCK
    framed = txq.transport_framing(ts.reshape(n_pkt, 188)).reshape(-1)
    bits = bitops.bytes_to_bits(framed)
    info = bitops.bits_to_words(bits.reshape(-1, 7), 7).reshape(-1)
    cw = txq.rs_encode(info.reshape(-1, txq.RS_K)).reshape(-1)
    inter, _c = txq.interleave(cw.astype(jnp.int32), st.ilv_carry)
    frame_bits = jnp.zeros(
        (txq.FRAMES_PER_SUPERBLOCK * (txq.FRAME_SYMBOLS * 7 + 42),),
        jnp.uint8)

    P = functools.partial
    return [
        profile_fn("encode_to_cells", P(txq.encode_to_cells, cfg),
                   (ts, st)),
        profile_fn("  sub: framing+symbolize",
                   lambda t: bitops.bits_to_words(
                       bitops.bytes_to_bits(
                           txq.transport_framing(t.reshape(n_pkt, 188))
                           .reshape(-1)).reshape(-1, 7), 7), (ts,)),
        profile_fn("  sub: rs_encode",
                   lambda i: txq.rs_encode(i.reshape(-1, txq.RS_K)),
                   (info,)),
        profile_fn("  sub: interleave",
                   lambda c, carry: txq.interleave(c, carry)[0],
                   (cw.astype(jnp.int32), st.ilv_carry)),
        profile_fn("  sub: trellis+map",
                   lambda fb, st_=st: jnp.asarray(
                       txq.CONSTELLATION_64_RAILS)[
                       :, txq.trellis_encode(fb, st_.conv_a, st_.conv_b,
                                             st_.diff_state)[0]],
                   (frame_bits,)),
        profile_fn("rrc_interpolate",
                   lambda c, t: txq.rrc_interpolate(c, t, taps),
                   (cells, st.rrc_tail)),
        profile_fn("FULL superblock", P(txq.modulate_superblock, cfg),
                   (ts, st)),
    ]


def papr_stages(cfg=None):
    """Stage profile of the PAPR analyzer's device scans (16M-complex
    chunk, the bench_papr shape)."""
    import jax.numpy as jnp

    from dtv_utils_tpu.analysis import papr as pp

    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.standard_normal(1 << 25, dtype=np.float32))
    levels = jnp.asarray(np.power(10.0, np.arange(11) / 10.0)
                         .astype(np.float32))
    return [
        profile_fn("pass1 (power+peaks+rails)",
                   lambda r, z: pp._pass1_chunk(r, z), (raw, pp.ZERO)),
        profile_fn("pass2 (ccdf histogram)",
                   lambda r, lv, z: pp._pass2_chunk(r, lv, z),
                   (raw, levels, pp.ZERO)),
    ]


def _dvbt2_bbc_stages() -> list[StageReport]:
    from dtv_utils_tpu.models.dvbt2 import PROFILES
    return dvbt2_stages(PROFILES["bbc"])


CHAINS = {"dvbt": dvbt_stages, "dvbt2": dvbt2_stages,
          "dvbt2-bbc": _dvbt2_bbc_stages, "j83b": j83b_stages,
          "papr": papr_stages}


def format_table(reports: list[StageReport]) -> str:
    rows = [f"{'stage':<28} {'ms':>9} {'GFLOP':>8} {'MB io':>9} "
            f"{'MB xla':>9} {'AI':>7} {'roof%':>6} bound"]
    for r in reports:
        pct = f"{r.roofline_pct:5.1f}" if r.roofline_pct is not None else "  n/a"
        rows.append(f"{r.name:<28} {r.ms:9.3f} {r.flops / 1e9:8.3f} "
                    f"{r.bytes_io / 1e6:9.3f} {r.bytes_xla / 1e6:9.3f} "
                    f"{r.ai:7.2f} {pct:>6} {r.bound}")
    return "\n".join(rows)


def cli(argv: list[str]) -> int:
    import sys

    from dtv_utils_tpu.utils.metrics import Metrics

    json_mode = "-j" in argv
    names = [a for a in argv if not a.startswith("-")] or ["dvbt2"]
    for name in names:
        if name not in CHAINS:
            print(f"unknown chain <{name}> (choose from {list(CHAINS)})",
                  file=sys.stderr)
            return 255
    global ON_REPORT
    for name in names:
        if json_mode:
            # stream each row the moment it is measured (a run killed
            # mid-chain keeps every already-measured stage)
            m = Metrics(suppress_human=True)

            def _emit(r, name=name, m=m):
                m.emit(f"profile.{name}.{r.name}", round(r.ms, 4), "ms",
                       gflop=round(r.flops / 1e9, 4),
                       gop_int8=round(r.int8_flops / 1e9, 4),
                       mbytes_io=round(r.bytes_io / 1e6, 4),
                       mbytes_xla=round(r.bytes_xla / 1e6, 4),
                       mbytes_temp=round(r.temp_bytes / 1e6, 4),
                       roofline_pct=(round(r.roofline_pct, 2)
                                     if r.roofline_pct is not None else None),
                       bound=r.bound)
            ON_REPORT = _emit
            try:
                CHAINS[name]()
            finally:
                ON_REPORT = None
        else:
            print(f"== {name} ==")
            print(format_table(CHAINS[name]()))
    return 0
