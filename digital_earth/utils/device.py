"""The device a measurement ran on.

Every number this repo reports names its card: JAX's platform, device kind
and device count, plus the card's name and power limit as ``nvidia-smi``
reads them (a card set below its maximum power runs slower under load).
A measurement path that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's devices, which must be GPUs; raises RuntimeError otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devices[0].platform} devices only"
        )
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line;
    raises when the card cannot be read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return out


def device_record(devices) -> dict:
    """JSON-ready description of ``devices`` (the first one's kind)."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
