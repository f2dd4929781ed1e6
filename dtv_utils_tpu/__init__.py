"""dtv_utils_tpu — a JAX digital-television transmit & analysis framework.

A from-scratch JAX/XLA re-design of the capabilities of drmpeg/dtv-utils
(reference mounted at /root/reference): DVB-T / DVB-T2 / ITU-T J.83B transmit
chains, PAPR/CCDF IQ analysis, and exact vectorized rate oracles for
DVB-T/S2/S2X/T2 and ATSC 3.0, plus native C++ stream analyzers.

Design principles (not a port):
  * All FEC over GF(2^m) is expressed as GF(2) bit-plane linear algebra so the
    hot encode path is an integer matmul, not a byte-serial LFSR.
  * All interleavers are precomputed static gathers; stream carry-state is a
    small pytree exchanged between sequence shards via collectives.
  * OFDM symbols are batched through XLA's FFT; pilots/TPS are static
    scatters fused by XLA.
  * The time axis shards across a `jax.sharding.Mesh`; everything per-symbol
    is embarrassingly parallel, and only carry-state/halos cross shards.
"""

__version__ = "0.1.0"


def _enable_compilation_cache() -> None:
    """Persist XLA executables across processes (each CLI invocation would
    otherwise compile its chain again).  JAX itself honours
    JAX_COMPILATION_CACHE_DIR; without it the cache is the fixed
    <checkout>/.jax_cache."""
    import os
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    try:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    except Exception:   # cache is best-effort; never block import
        pass


_enable_compilation_cache()
