"""Test configuration: force an 8-device CPU mesh before JAX initializes.

Multi-device sharding is validated on virtual CPU devices; the GPU paths are
run on the card by chip_smoke.py. jax_platforms is pinned through jax.config
as well as the environment, so that nothing in the interpreter's start-up can
move the tests off the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
