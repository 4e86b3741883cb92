"""The device an entry point runs on."""

from __future__ import annotations

import torch


def entry_device(device) -> torch.device:
    """``device`` as a torch device; raises for a CUDA device when there is no
    card.  Entry points run on a card unless the caller asks for the CPU
    (``device="cpu"`` runs the kernels' plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but there is no CUDA device; "
                           "pass device='cpu' to run the plain versions")
    return dev
