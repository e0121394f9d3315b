"""What the accelerator is, for printing beside every measurement.

A card may be set below its maximum power and then runs slower under
load, so a time means little without the card's name and power limit.
``nvidia-smi`` runs as a child process that never imports JAX, so it
never opens the card.
"""

from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card.  Raises if nvidia-smi is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def jax_device() -> dict:
    """The default device as JAX reports it."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
