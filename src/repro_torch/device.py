"""Device resolution: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The torch device an entry point runs on.

    `None` means `cuda`.  A CUDA device is refused with a clear error when
    no GPU is visible: the port never falls back to the CPU on its own.
    Pass `device="cpu"` to run the plain PyTorch versions of the kernels.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch sees no GPU "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
