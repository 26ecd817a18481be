"""Test configuration: run JAX on a virtual 8-device CPU mesh in float64.

Parity tests reproduce the reference's double-precision convergence-rate
goldens, so they run on the CPU backend with x64 enabled; multi-chip sharding
tests use the 8 virtual CPU devices (the driver separately dry-runs the
multi-chip path via __graft_entry__.dryrun_multichip).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

# The tests run on the CPU even where JAX finds a GPU: the config API wins
# over JAX_PLATFORMS and over an installed CUDA plugin.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
