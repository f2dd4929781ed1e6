"""Test harness: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU (JAX_PLATFORMS=cpu); multi-device sharding is
validated by forcing the host platform to present 8 XLA CPU devices.  No
test opens a GPU: chip_smoke.py checks the main path on the card.

XLA:CPU's multi-threaded FFT is not bit-reproducible: the same batched
transform of the same input can differ in the last bit from one call to
the next (seen on DVB-T 2K carriers_to_iq; single-threaded it never
does).  The tests compare IQ bit
for bit (resume == one pass, sharded == serial), so they run the CPU
backend single-threaded.

Auto-loaded pytest plugins (jaxtyping et al.) may import jax before this
conftest runs, so jax.config is updated explicitly as well as os.environ.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_multi_thread_eigen" not in flags:
    flags += " --xla_cpu_multi_thread_eigen=false"
os.environ["XLA_FLAGS"] = flags.strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device, for tests marked ``gpu``; skips where there is
    none.  Decided here, at run time, never while modules are imported."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU here; chip_smoke.py checks the card")
