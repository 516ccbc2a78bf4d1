"""What the program runs on: the JAX device fields every measurement is
labelled with, the refusal to report a CPU run as a device run, and the
card's name and power limit as ``nvidia-smi`` reports them."""
from __future__ import annotations

import subprocess


def device_fields() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(platform_arg: str | None, prog: str) -> dict:
    """The device fields, after refusing to run on anything but a GPU unless
    the caller chose the CPU explicitly (``--platform cpu``).  There is no
    silent CPU fallback: a CPU number is never a device metric."""
    fields = device_fields()
    if platform_arg is None and fields["platform"] != "gpu":
        raise SystemExit(
            f"{prog}: JAX found no GPU (platform {fields['platform']!r}); "
            f"pass --platform cpu for a CPU run, whose numbers are not "
            f"device metrics")
    return fields


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, read
    in a child process that does not touch JAX; None where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None
