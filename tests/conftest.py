"""Test harness config: run everything on a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding code is validated on
``xla_force_host_platform_device_count=8`` CPU devices. Whether a GPU is
present is never decided here: tests that need the card decide inside the
test. Must run before the first ``import jax`` anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

assert len(jax.devices()) == 8, jax.devices()
