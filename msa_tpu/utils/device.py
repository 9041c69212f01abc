"""What a measurement ran on: the JAX device and the card's power limit."""

from __future__ import annotations

import subprocess


def describe() -> dict:
    """``{"platform", "kind", "count"}`` of the first JAX device."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def nvidia_smi() -> str:
    """The cards' name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
