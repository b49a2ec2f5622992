"""What a run executes on: the JAX device and the card's name and power limit.

Every measurement names its device, and a measurement path that finds no
GPU stops instead of falling back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys

import jax


def describe() -> dict:
    """platform / device_kind / count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi(query: str = "name,power.limit") -> list:
    """One line per card, as `nvidia-smi --query-gpu=<query>` prints it
    (empty when nvidia-smi is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpu(tool: str) -> dict:
    """describe() of the GPU backend; exits with status 1 when JAX finds no
    GPU (no CPU fallback)."""
    try:
        dev = describe()
    except RuntimeError as e:
        sys.exit(f"{tool}: JAX found no device: {e}")
    if dev["platform"] != "gpu":
        sys.exit(f"{tool}: needs an NVIDIA GPU; JAX found only "
                 f"{dev['platform']} ({dev['kind']})")
    return dev
