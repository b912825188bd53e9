"""Device resolution shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default and raises when CUDA is
missing; the CPU is used only when the caller names it. There is no silent
fallback, so a run on a machine without a card fails instead of measuring
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
