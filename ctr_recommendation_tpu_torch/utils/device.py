"""Device selection shared by the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU: a
missing CUDA device is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
