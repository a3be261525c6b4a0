"""Process environment for the launchers (serve, train, the dry run).

The port of `repro.launch.env`.  CUDA reads its variables once, when the
process first initialises it (torch's first CUDA call), so the
launchers call `setup_env()` at the very top of `main()`, before any
tensor meets the card.  Two rules carry over from the reference:

  * never clobber: every variable is set only where it is unset, so an
    operator's export wins over the defaults;
  * stay honest about the platform: `describe_env()` reports what torch
    actually sees (backend, device name, count, the card's power limit),
    which reports stamp beside every figure.

The variables, each read by CUDA at initialisation:

  * `CUDA_MODULE_LOADING=LAZY`: load a kernel module's functions when they
    are first launched, not all at context creation, so a process that
    builds and loads the port's kernel library (and torch's own) starts
    faster and keeps less device memory for code.  Recent torch sets the
    same default itself at its first CUDA call; setting it here makes it
    explicit and visible to `describe_env`.
  * `CUDA_DEVICE_ORDER=PCI_BUS_ID`: number the devices in PCI bus order,
    the order `nvidia-smi` lists them, so the name and power limit read
    from `nvidia-smi` belong to torch's device 0.

Nothing here changes the allocator: the reference's
`XLA_PYTHON_CLIENT_MEM_FRACTION=0.85` has no counterpart, because torch's
caching allocator takes memory as it is needed and the port's largest
cells need the whole 80 GB card.  The reference's fake host-device mesh
(`host_devices`) is the port's `ndev` argument, not a variable.
"""

from __future__ import annotations

import os
import subprocess

ENV_DEFAULTS = {
    "CUDA_MODULE_LOADING": "LAZY",
    "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
}


def setup_env() -> dict[str, str]:
    """Set the CUDA defaults of `ENV_DEFAULTS` where unset; returns the
    variables actually applied.  Must run before the first CUDA call."""
    applied: dict[str, str] = {}
    for key, value in ENV_DEFAULTS.items():
        if key not in os.environ:
            os.environ[key] = value
            applied[key] = value
    return applied


def nvidia_smi_line() -> str | None:
    """The first card's `name, power.limit` as `nvidia-smi` prints them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def describe_env(device=None) -> dict:
    """Backend and device facts for stamping onto reports.

    `device` (None: cuda when torch sees a card, else the CPU) picks the
    backend described.  Keys: `backend` ("cuda" | "cpu"), `device_kind`
    (`torch.cuda.get_device_name(0)`, or "cpu"), `n_devices`,
    `power_limit` (from `nvidia-smi`, None without a card), `nvidia_smi`
    (its whole line), `torch`, `cuda` (torch's CUDA version, None on a CPU
    build), and `env`: the variables `setup_env` reads, as set now."""
    import torch

    if device is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        backend = torch.device(device).type
    smi = nvidia_smi_line() if backend == "cuda" else None
    power = smi.rsplit(",", 1)[1].strip() if smi and "," in smi else None
    return {
        "backend": backend,
        "device_kind": torch.cuda.get_device_name(0) if backend == "cuda" else "cpu",
        "n_devices": torch.cuda.device_count() if backend == "cuda" else 1,
        "power_limit": power,
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "env": {k: os.environ.get(k) for k in ENV_DEFAULTS},
    }
