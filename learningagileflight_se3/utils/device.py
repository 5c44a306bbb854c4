"""What a measurement ran on: JAX's device and, on an NVIDIA card, the name
and power limit nvidia-smi reports (a card set below its maximum power runs
slower under load, so every number is kept beside them)."""

from __future__ import annotations

import subprocess

import jax


def gpu_name_and_power_limit() -> list[str]:
    """One 'name, power.limit' line per card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def describe_device() -> str:
    """'<device_kind> (<name>, <power limit>)' on a GPU, else the device
    kind JAX reports."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        return d.device_kind
    return f"{d.device_kind} ({gpu_name_and_power_limit()[0]})"
