"""The one place that decides which device the program is running on.

The program runs on an NVIDIA GPU (JAX platform "gpu") and, for the tests,
on the CPU.  Code whose behaviour depends on the device asks this module
instead of comparing `jax.default_backend()` strings itself.  Any other
platform is an error here, never a silent default: a path chosen for a
device the program was not written for would run untested.
"""

from __future__ import annotations

import subprocess

import jax

SUPPORTED_PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """JAX's default platform, checked against SUPPORTED_PLATFORMS."""
    name = jax.default_backend()
    if name not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}; mfmg_tpu runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}")
    return name


def is_gpu() -> bool:
    """True when the default device is a GPU (the accelerator paths)."""
    return platform() == "gpu"


def gpu_name_and_power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them.  A card set below its maximum power runs slower under load, so
    every measurement reports this beside its numbers."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]
