"""The GPU a measurement runs on.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
``require_gpu`` first: a number taken on another backend is never
reported as the card's.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's first device; exits non-zero unless it is a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is "
                         f"{dev.platform!r} ({dev.device_kind})")
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
