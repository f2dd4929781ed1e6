"""Normalized min-sum LDPC decoder for the DVB-T2/S2 IRA codes.

Receiver-side counterpart of the encoder in tx/dvbt2.py (the reference's
decoding happens in consumer silicon; its encoder is the gr-dtv block
pinned at /root/reference/dvbt2-blade.py:122).  The IRA parity-check
structure is taken from the SAME accumulator tables the encoder uses
(tx/dvbt2_tables.ldpc_accumulator_rows), so whatever table is loaded —
structure-exact stand-in or real annex data — encoder and decoder agree.

Check equations of the IRA code (c = [info | parity]):

  check p:  XOR_{edges (g,m)->p} info  ^  parity[p]  ^  parity[p-1]  = 0

i.e. every check touches its accumulator taps plus the two dual-diagonal
parity bits (one for p = 0).

Array formulation: the Tanner graph is three flat edge arrays (variable
index, check index) sorted by check; one min-sum iteration is

  * two ``segment_min`` passes (min / second-min of |messages| per check,
    with exact tie handling via a count), one ``segment_sum`` for the sign
    product — all static-shape XLA segment reductions;
  * a gather back to edges and a ``segment_sum`` over variables.

No data-dependent control flow: a fixed iteration count under
``lax.scan`` (early-exit would break batching; iterations are cheap).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dtv_utils_tpu.core.config import Dvbt2Config
from dtv_utils_tpu.tx import dvbt2_tables as T

MINSUM_SCALE = 0.75          # normalized min-sum correction factor


@functools.cache
def _graph(cfg: Dvbt2Config) -> dict[str, np.ndarray]:
    """Flat Tanner graph: (var[e], chk[e]) sorted by check index."""
    src, dst = T.ldpc_edge_arrays(
        (cfg.code_rate.value, cfg.nldpc, cfg.nbch, cfg.ldpc_q))
    n_parity = cfg.nldpc - cfg.nbch
    # info edges + dual-diagonal parity edges
    var = [src.astype(np.int64), cfg.nbch + np.arange(n_parity)]
    chk = [dst.astype(np.int64), np.arange(n_parity)]
    var.append(cfg.nbch + np.arange(n_parity - 1))
    chk.append(1 + np.arange(n_parity - 1))
    var = np.concatenate(var)
    chk = np.concatenate(chk)
    order = np.argsort(chk, kind="stable")
    return dict(var=var[order].astype(np.int32),
                chk=chk[order].astype(np.int32),
                n_parity=n_parity, n_edges=len(var))


def syndrome(cfg: Dvbt2Config, bits: jnp.ndarray) -> jnp.ndarray:
    """Hard bits [..., nldpc] -> per-check parity [..., n_parity] (0 = ok)."""
    g = _graph(cfg)
    contrib = jnp.take(bits, jnp.asarray(g["var"]), axis=-1)
    return jax.ops.segment_sum(
        contrib.astype(jnp.int32).T, jnp.asarray(g["chk"]),
        num_segments=g["n_parity"]).T % 2


def decode(cfg: Dvbt2Config, llr: jnp.ndarray, iterations: int = 30
           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Min-sum decode: channel LLRs [batch, nldpc] (positive = bit 0) ->
    (hard bits uint8 [batch, nldpc], ok bool [batch])."""
    g = _graph(cfg)
    var = jnp.asarray(g["var"])
    chk = jnp.asarray(g["chk"])
    n_par = g["n_parity"]
    n_edges = g["n_edges"]
    batch = llr.shape[0]
    llr = llr.astype(jnp.float32)
    big = jnp.float32(1e30)

    def seg_min(x):
        return jax.ops.segment_min(x.T, chk, num_segments=n_par).T

    def seg_sum(x, idx, num):
        return jax.ops.segment_sum(x.T, idx, num_segments=num).T

    def one_iter(c2v, _):
        # variable-to-check: total belief minus this check's contribution
        totals = llr + seg_sum(c2v, var, cfg.nldpc)       # [b, nldpc]
        v2c = jnp.take(totals, var, axis=1) - c2v         # [b, E]
        mag = jnp.abs(v2c)
        neg = (v2c < 0).astype(jnp.int32)
        # per-check: min, exact second-min (tie-aware), sign product
        m1 = seg_min(mag)                                  # [b, n_par]
        m1e = jnp.take(m1, chk, axis=1)
        is_min = mag <= m1e
        n_min = seg_sum(is_min.astype(jnp.int32), chk, n_par)
        m2 = seg_min(jnp.where(is_min, big, mag))
        sign_par = seg_sum(neg, chk, n_par) % 2            # [b, n_par]
        # check-to-variable
        other = jnp.where(
            is_min & (jnp.take(n_min, chk, axis=1) == 1),
            jnp.take(m2, chk, axis=1), m1e)
        s = 1.0 - 2.0 * ((jnp.take(sign_par, chk, axis=1) ^ neg)
                         .astype(jnp.float32))
        return MINSUM_SCALE * s * other, None

    c2v0 = jnp.zeros((batch, n_edges), dtype=jnp.float32)
    c2v, _ = jax.lax.scan(one_iter, c2v0, None, length=iterations)
    totals = llr + seg_sum(c2v, var, cfg.nldpc)
    hard = (totals < 0).astype(jnp.uint8)
    ok = jnp.all(syndrome(cfg, hard) == 0, axis=-1)
    return hard, ok


@functools.cache
def jit_decode(cfg: Dvbt2Config, iterations: int = 30):
    return jax.jit(functools.partial(decode, cfg, iterations=iterations))
