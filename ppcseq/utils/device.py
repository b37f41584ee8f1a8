"""Which device a measurement ran on, stated in its output.

Every benchmark prints the platform, `device_kind` and device count JAX
reports, and the card's name and power limit as nvidia-smi gives them (a
card set below its maximum limit runs slower under load). A measurement
that finds no GPU fails, unless the caller asked for the CPU by name.
"""

from __future__ import annotations

import subprocess


def nvidia_smi() -> str:
    """`name, power.limit` of each card, from an nvidia-smi child process.

    The child never imports JAX, so it holds no device memory.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def describe(cpu: bool = False) -> dict:
    """Platform, device kind and count (+ the nvidia-smi line on a GPU).

    Raises RuntimeError when JAX's first device is not a GPU and `cpu` was
    not asked for: a benchmark never falls back to the CPU on its own.
    """
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu" and not cpu:
        raise RuntimeError(
            f"no GPU: JAX's first device is {d.platform!r} ({d.device_kind}); "
            "pass --cpu to measure the CPU"
        )
    info = {"platform": d.platform, "device_kind": d.device_kind, "device_count": len(devs)}
    if d.platform == "gpu":
        info["nvidia_smi"] = nvidia_smi()
    return info


def force_cpu() -> None:
    """Pin JAX to the CPU backend; call before any backend use."""
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
