"""Which device an entry point runs on.

Entry points run on the CUDA card unless the caller asks for the CPU.  They
never fall back to the CPU on their own: a host without CUDA raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The concrete device for `device` (None = the current CUDA card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run its plain PyTorch versions "
                "on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
